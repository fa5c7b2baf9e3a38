"""Carry the reference's weights into the port.

``params_from_reference`` takes the pytree of ``repro.models.init_params``
as host arrays and returns the port's ``Model`` with the same values, bit
for bit.  The reference stacks every layer leaf on a leading
``(n_layers,)`` dim; here each layer is its own module, so the stack is
unstacked.  bf16 leaves arrive as ``ml_dtypes`` bfloat16 arrays (what
``np.asarray`` gives for a jax array) or as their uint16 bit patterns;
both cross as 16-bit patterns.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.devices import resolve_device
from repro_torch.core.engine import _to_tensor
from repro_torch.models.model import Model


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint16:                 # bf16 bit patterns
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return _to_tensor(a)


def _leaves(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _fill(params: Dict[str, nn.Parameter], leaves: Dict, layer=None,
          n_layers=None) -> None:
    """Copy each parameter from the reference leaf of the same path;
    ``layer`` indexes a stacked leading dim of length ``n_layers``."""
    if set(params) != set(leaves):
        raise ValueError(f"reference leaves without a port parameter: "
                         f"{sorted(set(leaves) - set(params))}; port "
                         f"parameters without a reference leaf: "
                         f"{sorted(set(params) - set(leaves))}")
    for name, param in params.items():
        src = leaves[name]
        if layer is not None:
            if src.shape[0] != n_layers:
                raise ValueError(f"layers.{name}: {src.shape[0]} layers "
                                 f"stacked, the config has {n_layers}")
            src = src[layer]
        if src.shape != param.shape or src.dtype != param.dtype:
            raise ValueError(f"{name}: reference {tuple(src.shape)} "
                             f"{src.dtype}, port {tuple(param.shape)} "
                             f"{param.dtype}")
        param.copy_(src)


def params_from_reference(np_params: Mapping, cfg, device=None) -> Model:
    """The port's ``Model`` holding the reference's ``init_params`` values
    (same dtypes, same bits) on ``device`` (the card unless ``"cpu"``)."""
    p = Model(cfg, device=resolve_device(device))
    top = {n: t for n, t in p.named_parameters()
           if not n.startswith("layers.")}
    with torch.no_grad():
        _fill(top, {n: _tensor(a) for n, a in _leaves(np_params)
                    if not n.startswith("layers.")})
        stacked = {n: _tensor(a) for n, a in _leaves(np_params["layers"])}
        for i, layer in enumerate(p.layers):
            _fill(dict(layer.named_parameters()), stacked, layer=i,
                  n_layers=len(p.layers))
    return p
