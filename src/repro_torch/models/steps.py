"""Step factories: train, grad, apply, prefill and decode.  Port of
``repro.models.steps``.  Each factory closes over the config and returns a
plain function: PyTorch runs eagerly, so there is nothing to jit.

The training steps update the ``Model`` and the optimizer state in place
(the reference's pure step returns new ones; a step here returns the same
objects, updated).  Gradients come from ``torch.autograd.grad`` of
``model.loss_fn`` and never sit in ``.grad``.  The serving steps run under
``torch.inference_mode()``, so a model whose parameters require gradients
serves exactly as one whose do not.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.devices import resolve_device
from repro_torch.core.engine import _to_tensor
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def _loss_and_grads(params: M.Model, cfg, batch: Dict
                    ) -> Tuple[torch.Tensor, Dict, Dict[str, torch.Tensor]]:
    named = dict(params.named_parameters())
    with torch.enable_grad():
        loss, metrics = M.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, dict(zip(named, grads))


def _split(batch: Dict, m: int):
    """The m microbatches of ``batch``: each array with a leading dim that
    m divides is cut into m equal runs of rows; others are shared.  M-RoPE
    ``positions`` (3, B, S) are cut on dim 1, as the reference's
    ``split_pos`` does."""

    def part(x, i, positions=False):
        x = x if isinstance(x, torch.Tensor) else _to_tensor(x)
        if positions and x.ndim == 3:
            n = x.shape[1] // m
            return x[:, i * n:(i + 1) * n]
        if x.ndim >= 1 and x.shape[0] % m == 0:
            n = x.shape[0] // m
            return x[i * n:(i + 1) * n]
        return x

    return [{k: part(v, i, k == "positions") for k, v in batch.items()}
            for i in range(m)]


def accumulate_grads(params: M.Model, cfg, batch: Dict, microbatches: int
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean loss, {name: fp32 gradient}) of ``batch`` split into
    ``microbatches`` on dim 0: each microbatch's gradients summed in fp32,
    then divided by their count."""
    acc, losses = None, []
    for mb in _split(batch, microbatches):
        loss, _, g = _loss_and_grads(params, cfg, mb)
        if acc is None:
            acc = {n: gi.float() for n, gi in g.items()}
        else:
            for n, gi in g.items():
                acc[n] += gi.float()
        losses.append(loss)
        del g
    for a in acc.values():
        a /= microbatches
    return torch.stack(losses).mean(), acc


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None,
                    microbatches: Optional[int] = None) -> Callable:
    """One optimizer step: ``train_step(params, opt_state, batch)`` ->
    (params, opt_state, metrics), the first two updated in place.  With
    microbatches > 1 the batch is split on dim 0, the gradients summed in
    fp32 and divided by m, then one AdamW update; the loss is the mean of
    the microbatch losses."""
    opt_cfg = opt_cfg or AdamWConfig()
    m = microbatches if microbatches is not None else getattr(
        cfg, "microbatches", 1)

    def monolithic(params, opt_state, batch):
        loss, metrics, grads = _loss_and_grads(params, cfg, batch)
        opt_metrics = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    if m <= 1:
        return monolithic

    def train_step(params, opt_state, batch):
        loss, grads = accumulate_grads(params, cfg, batch, m)
        opt_metrics = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {**opt_metrics, "loss": loss, "nll": loss}

    return train_step


def make_grad_step(cfg) -> Callable:
    """Gradient-only step for accumulation drivers: ``grad_step(params,
    batch)`` -> ({name: grad}, metrics)."""

    def grad_step(params, batch):
        loss, metrics, grads = _loss_and_grads(params, cfg, batch)
        return grads, {**metrics, "loss": loss}

    return grad_step


def make_apply_grads(cfg, opt_cfg: Optional[AdamWConfig] = None) -> Callable:
    """``apply_grads(params, opt_state, grads)`` -> ``{"grad_norm", "lr"}``,
    the update in place."""
    opt_cfg = opt_cfg or AdamWConfig()

    def apply_grads(params, opt_state, grads):
        return adamw_update(opt_cfg, params, grads, opt_state)

    return apply_grads


def make_prefill_step(cfg) -> Callable:
    def prefill_step(params, batch):
        """Full-sequence forward -> last-token logits (B, 1, V) fp32."""
        with torch.inference_mode():
            h, _ = M.forward(params, cfg, batch["tokens"],
                             frontend_embeds=batch.get("frontend_embeds"),
                             positions=batch.get("positions"))
            return M.unembed(params, cfg, h[:, -1:])

    return prefill_step


def make_decode_step(cfg) -> Callable:
    def decode_step(params, caches, token, pos):
        """One greedy token: (next_token (B, 1) int32, logits, caches)."""
        with torch.inference_mode():
            logits, caches = M.decode_step(params, cfg, token, caches, pos)
            next_token = torch.argmax(logits[:, -1], dim=-1).to(
                torch.int32)[:, None]
        return next_token, logits, caches

    return decode_step


def init_train_state(cfg, *, seed: int = 0, device=None
                     ) -> Tuple[M.Model, dict]:
    """``init_params`` from ``seed`` with gradients turned on, and zero
    AdamW state, on ``device`` (the card unless ``"cpu"``)."""
    params = M.init_params(cfg, seed=seed, device=resolve_device(device))
    params.requires_grad_(True)
    return params, adamw_init(params)
