"""The two serving steps: prefill and greedy decode.  Port of
``make_prefill_step`` and ``make_decode_step`` of ``repro.models.steps``
(the training steps wait for the training path, ROADMAP Queue A item 9).
Each factory closes over the config and returns a plain function: PyTorch
runs eagerly, so there is nothing to jit."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import model as M


def make_prefill_step(cfg) -> Callable:
    def prefill_step(params, batch):
        """Full-sequence forward -> last-token logits (B, 1, V) fp32."""
        h, _ = M.forward(params, cfg, batch["tokens"],
                         positions=batch.get("positions"))
        return M.unembed(params, cfg, h[:, -1:])

    return prefill_step


def make_decode_step(cfg) -> Callable:
    def decode_step(params, caches, token, pos):
        """One greedy token: (next_token (B, 1) int32, logits, caches)."""
        logits, caches = M.decode_step(params, cfg, token, caches, pos)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return next_token, logits, caches

    return decode_step
