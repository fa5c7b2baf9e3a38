"""Production mesh construction — port of ``repro.launch.mesh``.

A mesh is the port's ``core/distributed.PodMesh``: a named grid of
``torch.device``s.  The production meshes stand for the reference's TPU
pods, (data 16, model 16) and (pod 2, data 16, model 16), and hold
``meta`` devices: they are for accounting (``launch/sharding.py``,
``launch/dryrun.py``), and nothing computes on them.  The host mesh is a
(1, 1) mesh that computes, on the card unless the caller asks for the CPU.
The reference's ``_auto_axis_kwargs`` (a shim over JAX versions) has no
counterpart.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.devices import resolve_device
from repro_torch.core.distributed import PodMesh


def make_production_mesh(*, multi_pod: bool = False) -> PodMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return PodMesh(np.full(shape, "meta", dtype=object), axes)


def make_host_mesh(device=None) -> PodMesh:
    """Single-device (data 1, model 1) mesh for smoke tests and examples,
    on the card unless ``device="cpu"``."""
    return PodMesh(np.full((1, 1), str(resolve_device(device)), dtype=object),
                   ("data", "model"))


def data_axes(mesh) -> tuple:
    """Axes used for batch/data parallelism (includes 'pod' when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh) -> str:
    return "model"


def n_devices(mesh) -> int:
    return int(np.prod(mesh.devices.shape))
