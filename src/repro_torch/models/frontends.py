"""Modality frontend stubs.  Port of ``repro.models.frontends``.

The ``[audio]`` and ``[vlm]`` archs specify the transformer backbone only:
whisper's encoder takes precomputed frame embeddings and qwen2-vl /
llama4-scout take precomputed patch embeddings, fused into the first
``n_frontend_tokens`` positions.  These helpers make deterministic
synthetic embeddings of those shapes for the smoke runs and the tests.
"""

from __future__ import annotations

import torch

from repro_torch.core.devices import resolve_device


def frontend_embed_shape(cfg, batch: int):
    if cfg.frontend == "none":
        return None
    return (batch, cfg.n_frontend_tokens, cfg.d_model)


def synthetic_frontend_embeds(cfg, batch: int, seed: int = 0, device=None):
    """N(0, 1)·0.02 drawn in fp32 from a ``torch.Generator`` seeded with
    ``seed``, cast to bf16, on ``device`` (the card unless ``"cpu"``); None
    for an arch without a frontend."""
    shape = frontend_embed_shape(cfg, batch)
    if shape is None:
        return None
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, dtype=torch.float32, device=dev)
            * 0.02).to(torch.bfloat16)
