"""The uniform dense decoder stack: full-sequence forward and single-token
cached decode.  Port of the dense part of ``repro.models.transformer``.

The reference stacks every layer's leaves on a leading ``(n_layers,)`` dim
and runs ``lax.scan`` over them; here the layers are an ``nn.ModuleList``
and the scan is a Python loop.  With ``cfg.remat`` and autograd on, each
layer is rematerialised in the backward (``torch.utils.checkpoint``, the
counterpart of the reference's ``nothing_saveable`` scan body): a layer
keeps only its input, and K8 runs again in the recompute.  The KV caches
keep the reference's stacked layout ``(n_layers, B, S, Hkv, hd)`` and are
written in place.  MoE layers and the other families (hybrid, encdec, ssm)
raise, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (MLP, Attention, Norm, apply_norm,
                                       attention, attention_qkv, cache_update,
                                       decode_attention, linear, mlp)

NOT_PORTED = ("is not ported yet: ROADMAP Queue A, item 9 (the other model "
              "families)")


class DecoderLayer(nn.Module):
    """ln1, attn, ln2, mlp — the reference's per-layer param dict."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        if cfg.is_moe:
            raise NotImplementedError(f"the MoE layer (moe_ffn) {NOT_PORTED}")
        bias = cfg.norm == "layernorm"
        self.ln1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = Attention(cfg, bias=bias, device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, bias=bias,
                       device=device)


def init_decoder_layer(cfg, g: torch.Generator, *, device=None) -> DecoderLayer:
    p = DecoderLayer(cfg, device=device)
    for lin in (p.attn.wq, p.attn.wk, p.attn.wv, p.attn.wo):
        lin.init_(g)
    for name in ("wg", "wu", "wd"):
        if hasattr(p.mlp, name):
            getattr(p.mlp, name).init_(g)
    return p


def init_decoder_stack(cfg, g: torch.Generator, *, device=None) -> nn.ModuleList:
    return nn.ModuleList(init_decoder_layer(cfg, g, device=device)
                         for _ in range(cfg.n_layers))


def decoder_layer(p: DecoderLayer, x: torch.Tensor, cfg, angles
                  ) -> torch.Tensor:
    h = x + attention(p.attn, apply_norm(p.ln1, x, cfg.norm), cfg,
                      angles=angles, causal=True)
    return h + mlp(p.mlp, apply_norm(p.ln2, h, cfg.norm), cfg.act)


def decoder_stack(layers: nn.ModuleList, x: torch.Tensor, cfg, angles
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden, aux); aux is the MoE router loss, 0 for dense."""
    remat = cfg.remat and torch.is_grad_enabled()
    for p in layers:
        x = (checkpoint(decoder_layer, p, x, cfg, angles, use_reentrant=False)
             if remat else decoder_layer(p, x, cfg, angles))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def decoder_layer_decode(p: DecoderLayer, x: torch.Tensor, cfg, angles,
                         k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos: int) -> torch.Tensor:
    """Single-token step.  x: (B, 1, d); caches (B, S, Hkv, hd), written in
    place at ``pos``."""
    B = x.shape[0]
    q, k, v = attention_qkv(p.attn, apply_norm(p.ln1, x, cfg.norm), cfg,
                            angles)
    cache_update(k_cache, k, pos)
    cache_update(v_cache, v, pos)
    o = decode_attention(q, k_cache, v_cache, pos)
    h = x + linear(p.attn.wo, o.reshape(B, 1, cfg.n_heads * cfg.head_dim))
    return h + mlp(p.mlp, apply_norm(p.ln2, h, cfg.norm), cfg.act)


def decoder_stack_decode(layers: nn.ModuleList, x: torch.Tensor, cfg, angles,
                         caches: dict, pos: int) -> Tuple[torch.Tensor, dict]:
    for i, p in enumerate(layers):
        x = decoder_layer_decode(p, x, cfg, angles, caches["k"][i],
                                 caches["v"][i], pos)
    return x, caches


def init_kv_caches(cfg, batch: int, seq: int, *, device=None) -> dict:
    """Zero caches ``{"k", "v"}`` of shape (L, B, S, Hkv, hd), bf16 (the
    reference's: the cache rounds K/V to bf16 whatever the weights are)."""
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
