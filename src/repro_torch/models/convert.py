"""Carry the reference's weights into the port.

``params_from_reference`` takes the pytree of ``repro.models.init_params``
as host arrays and returns the port's ``Model`` with the same values, bit
for bit, for every family.  The reference stacks every layer leaf on a
leading ``(n_layers,)`` dim (``layers``, ``hybrid.mamba_layers``,
``encdec.encoder``, ``encdec.decoder``); here each layer is its own
module, so the stacks are unstacked.  bf16 leaves arrive as
``ml_dtypes`` bfloat16 arrays (what ``np.asarray`` gives for a jax array)
or as their uint16 bit patterns; both cross as 16-bit patterns.
``opt_state_from_reference`` carries the reference's AdamW state (``{"m",
"v", "step"}``, moments shaped like the params) onto the port's parameter
names, so both sides can start mid-run.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.devices import resolve_device
from repro_torch.core.engine import _to_tensor
from repro_torch.models.model import Model
from repro_torch.optim import adamw_init


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


# the reference's layer stacks (a leading (n_layers,) dim on every leaf
# under them); the port holds each as an nn.ModuleList of the same name
STACKS = ("layers.", "hybrid.mamba_layers.", "encdec.encoder.",
          "encdec.decoder.")


def _unstacked(np_tree: Mapping, model: Model) -> Dict[str, torch.Tensor]:
    """{port parameter name: tensor} of a tree shaped like the reference's
    params, each layer stack cut into ``<stack>.<i>.`` (``hybrid.inv_proj``
    and ``encdec.enc_pos`` are single parameters and stay whole); refuses a
    tree that does not cover the model's parameters exactly."""
    out = {}
    for n, a in _leaves(np_tree):
        t = _tensor(a)
        stack = next((s for s in STACKS if n.startswith(s)), None)
        if stack is None:
            out[n] = t
            continue
        L = len(model.get_submodule(stack[:-1])) \
            if _has(model, stack[:-1]) else 0
        if t.shape[0] != L:
            raise ValueError(f"{n}: {t.shape[0]} layers stacked, the "
                             f"model has {L}")
        for i in range(L):
            out[f"{stack}{i}.{n[len(stack):]}"] = t[i]
    names = {n for n, _ in model.named_parameters()}
    if set(out) != names:
        raise ValueError(f"reference leaves without a port parameter: "
                         f"{sorted(set(out) - names)}; port parameters "
                         f"without a reference leaf: {sorted(names - set(out))}")
    return out


def _has(model: nn.Module, path: str) -> bool:
    try:
        model.get_submodule(path)
    except AttributeError:
        return False
    return True


def _fill(params: Dict[str, nn.Parameter],
          tensors: Dict[str, torch.Tensor]) -> None:
    """Copy each parameter from the tensor of the same name, which must
    have its shape and dtype."""
    for name, param in params.items():
        src = tensors[name]
        if src.shape != param.shape or src.dtype != param.dtype:
            raise ValueError(f"{name}: reference {tuple(src.shape)} "
                             f"{src.dtype}, port {tuple(param.shape)} "
                             f"{param.dtype}")
        param.copy_(src)


def params_from_reference(np_params: Mapping, cfg, device=None) -> Model:
    """The port's ``Model`` holding the reference's ``init_params`` values
    (same dtypes, same bits) on ``device`` (the card unless ``"cpu"``)."""
    p = Model(cfg, device=resolve_device(device))
    with torch.no_grad():
        _fill(dict(p.named_parameters()), _unstacked(np_params, p))
    return p


def opt_state_from_reference(np_opt_state: Mapping, model: Model) -> dict:
    """The reference's ``adamw_init``/``adamw_update`` state as host arrays
    -> the port's ``{"m": {name: fp32}, "v": {name: fp32}, "step": int32}``
    on ``model``'s device, bit for bit."""
    state = adamw_init(model)
    with torch.no_grad():
        for key in ("m", "v"):
            _fill(state[key], _unstacked(np_opt_state[key], model))
    state["step"].fill_(int(np.asarray(np_opt_state["step"])))
    return state
