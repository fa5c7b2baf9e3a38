"""The system under test: the only module of the benchmark that imports the
program (``repro_torch``, the PyTorch and CUDA port).

From the program the benchmark takes the index, the serving engine, their
counters and their kernels' launch counts; nothing here computes a metric.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def check_program() -> None:
    """Raises ImportError where the program is not there to measure."""
    import repro_torch.core  # noqa: F401


def build_index(cfg: dict, vectors: np.ndarray, device: torch.device):
    """The port's index over ``vectors``: the class of ``repro_torch.core``
    that the configuration names (``index_class``), built by its normal
    constructor from the configuration's ``index`` block, and a mutable
    index's ``UpdateParams`` from its ``update`` block."""
    from repro_torch import core
    cls = getattr(core, cfg["index_class"])
    args = [core.IndexConfig(**cfg["index"]), vectors]
    if "update" in cfg:
        args.append(core.UpdateParams(**cfg["update"]))
    return cls(*args, device=device)


def search_params(cfg: dict):
    from repro_torch.core import SearchParams
    return SearchParams(**cfg["search"])


def engine(index, params, serve: dict):
    """The port's serving engine over ``index``; building it captures its
    stage programs for every bucket of its ladder."""
    from repro_torch.serving import ServeParams, ThroughputEngine
    return ThroughputEngine(index, params, ServeParams(**serve))


def build_kernels() -> None:
    """Build (or load from the kernel cache) the CUDA sources a search
    runs, in parallel."""
    from repro_torch.kernels import _build
    _build.build_all(("traversal", "fes", "build"))


def launch_counts() -> Dict[str, int]:
    from repro_torch import kernels
    return dict(kernels.launch_counts())
