"""AdamW with bf16 parameters and fp32 moments, global-norm clipping.  Port
of ``repro.optim.adamw``.

The reference's functions are pure pytree maps; here the parameters are
updated in place, under ``torch.no_grad()``, which is PyTorch's idiom and
saves the second copy of the weights.  The arithmetic is the reference's,
operation for operation in fp32: clip by the global norm (summed in fp32
over every leaf, the clipped gradient cast back to its own dtype), bias
corrections from the step, ``update = m̂/(√v̂ + eps) + wd·p32`` and ``p =
p32 − lr·update`` cast back to the parameter's dtype.

``params`` is a ``Model`` (any ``nn.Module``: its ``named_parameters()``)
or a flat mapping of name to tensor; ``grads`` maps the same names to
tensors.  The state is ``{"m": {name: fp32}, "v": {name: fp32}, "step":
int32 0-d tensor}`` on the parameters' device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def named(params: Params) -> Dict[str, torch.Tensor]:
    """name -> tensor of a module's parameters or of a flat mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params: Params) -> dict:
    ps = named(params)
    dev = next(iter(ps.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for n, p in ps.items()},
            "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for n, p in ps.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine to 0.1·lr; ``step`` an fp32 0-d tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled by min(1, max_norm/‖g‖), each in its own dtype; ‖g‖),
    the norm summed in fp32 leaf by leaf."""
    gn = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params,
                 grads: Mapping[str, torch.Tensor], state: dict
                 ) -> Dict[str, torch.Tensor]:
    """One AdamW step, in place on ``params`` and ``state``.  Returns
    ``{"grad_norm", "lr"}`` (0-d tensors on the device)."""
    ps = named(params)
    if set(grads) != set(ps):
        raise ValueError(f"gradients for {sorted(set(grads) ^ set(ps))} do "
                         f"not match the parameters")
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    state["step"] += 1
    step = state["step"].float()
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step)
    bc2 = 1 - torch.pow(b2, step)
    for n, p in ps.items():
        g32 = grads[n].float()
        m = b1 * state["m"][n] + (1 - b1) * g32
        v = b2 * state["v"][n] + (1 - b2) * torch.square(g32)
        state["m"][n].copy_(m)
        state["v"][n].copy_(v)
        p32 = p.float()
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        update = update + cfg.weight_decay * p32
        p.copy_((p32 - lr * update).to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
