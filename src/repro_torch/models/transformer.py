"""Architecture stacks: the uniform decoder (dense, MoE, VLM), the zamba2
hybrid, whisper's encoder-decoder and RWKV6, each with the full-sequence
forward and the single-token cached decode.  Port of
``repro.models.transformer``.

The reference stacks every layer's leaves on a leading ``(n_layers,)`` dim
and runs ``lax.scan`` over them; here the layers are an ``nn.ModuleList``
and the scan is a Python loop.  With ``cfg.remat`` and autograd on, each
layer (and the hybrid's shared block) is rematerialised in the backward
(``torch.utils.checkpoint``, the counterpart of the reference's
``nothing_saveable`` scan body): a layer keeps only its input, and K8 runs
again in the recompute.  Caches and decode states keep the reference's
stacked layout (a leading layer dim) and are written in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (MLP, Attention, Norm, _param,
                                       apply_norm, attention, attention_qkv,
                                       cache_update, decode_attention, linear,
                                       mlp)
from repro_torch.models.moe import MoE, moe_ffn


def _run(fn, cfg, *args):
    """``fn(*args)``, rematerialised in the backward when ``cfg.remat`` and
    autograd are on."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ===========================================================================
# Uniform decoder stack (dense / moe / vlm)
# ===========================================================================

class DecoderLayer(nn.Module):
    """ln1, attn, ln2, and mlp or (MoE configs) moe."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        bias = cfg.norm == "layernorm"
        self.ln1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = Attention(cfg, bias=bias, device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device=device)
        if cfg.is_moe:
            self.moe = MoE(cfg, device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, bias=bias,
                           device=device)

    def init_(self, g: torch.Generator) -> None:
        self.attn.init_(g)
        (self.moe if hasattr(self, "moe") else self.mlp).init_(g)


def _ffn(p: DecoderLayer, x: torch.Tensor, cfg
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.is_moe:
        return moe_ffn(p.moe, x, cfg)
    return (mlp(p.mlp, x, cfg.act),
            torch.zeros((), dtype=torch.float32, device=x.device))


def decoder_layer(p: DecoderLayer, x: torch.Tensor, cfg, angles
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x + attention(p.attn, apply_norm(p.ln1, x, cfg.norm), cfg,
                      angles=angles, causal=True)
    y, aux = _ffn(p, apply_norm(p.ln2, h, cfg.norm), cfg)
    return h + y, aux


def decoder_stack(layers: nn.ModuleList, x: torch.Tensor, cfg, angles
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden, aux): aux sums the MoE router losses (0 dense)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layers:
        x, a = _run(decoder_layer, cfg, p, x, cfg, angles)
        aux = aux + a
    return x, aux


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
    return h + _ffn(p, apply_norm(p.ln2, h, cfg.norm), cfg)[0]


def decoder_stack_decode(layers: nn.ModuleList, x: torch.Tensor, cfg, angles,
                         caches: dict, pos: int) -> Tuple[torch.Tensor, dict]:
    for i, p in enumerate(layers):
        x = decoder_layer_decode(p, x, cfg, angles, caches["k"][i],
                                 caches["v"][i], pos)
    return x, caches


def init_kv_caches(cfg, batch: int, seq: int, *, n_layers: Optional[int] = None,
                   device=None) -> dict:
    """Zero caches ``{"k", "v"}`` of shape (L, B, S, Hkv, hd), bf16 (the
    reference's: the cache rounds K/V to bf16 whatever the weights are)."""
    L = cfg.n_layers if n_layers is None else n_layers
    shape = (L, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


# ===========================================================================
# Zamba2 hybrid: Mamba2 backbone + ONE shared attention/MLP block
# ===========================================================================

class MambaLayer(nn.Module):
    """norm, mamba."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.norm = Norm(cfg.d_model, cfg.norm, device=device)
        self.mamba = ssm_mod.Mamba2(cfg, device=device)


class Hybrid(nn.Module):
    """``mamba_layers`` (n_layers), ``shared_ln`` over 2·d_model,
    ``shared_attn`` reading 2·d_model, ``shared_ln2``, ``shared_mlp``, and
    ``inv_proj`` (n_inv, d, d) bf16: one output projector per invocation of
    the shared block (one parameter, not a layer stack)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d = cfg.d_model
        n_inv = cfg.n_layers // cfg.shared_attn_period
        self.mamba_layers = nn.ModuleList(
            MambaLayer(cfg, device=device) for _ in range(cfg.n_layers))
        self.shared_ln = Norm(2 * d, cfg.norm, device=device)
        self.shared_attn = Attention(cfg, d_in=2 * d, device=device)
        self.shared_ln2 = Norm(d, cfg.norm, device=device)
        self.shared_mlp = MLP(d, cfg.d_ff, cfg.act, device=device)
        self.inv_proj = _param((n_inv, d, d), torch.bfloat16, device)

    def init_(self, g: torch.Generator) -> None:
        for lp in self.mamba_layers:
            lp.mamba.init_(g)
        self.shared_attn.init_(g)
        self.shared_mlp.init_(g)
        self.inv_proj.copy_(torch.randn(
            self.inv_proj.shape, generator=g, dtype=torch.float32,
            device=self.inv_proj.device).to(torch.bfloat16) * 0.02)


def _shared_block(p: Hybrid, h: torch.Tensor, emb0: torch.Tensor, cfg,
                  inv: int, angles, cache=None, pos: Optional[int] = None
                  ) -> torch.Tensor:
    """The shared attention + MLP block on concat(h, the embeddings), its
    output through invocation ``inv``'s projector.  With ``cache`` (k, v)
    one decode step, the cache written in place."""
    B = h.shape[0]
    zin = apply_norm(p.shared_ln, torch.cat([h, emb0], dim=-1), cfg.norm)
    if cache is None:
        a = attention(p.shared_attn, zin, cfg, angles=angles, causal=True)
    else:
        k_cache, v_cache = cache
        q, k, v = attention_qkv(p.shared_attn, zin, cfg, angles)
        cache_update(k_cache, k, pos)
        cache_update(v_cache, v, pos)
        o = decode_attention(q, k_cache, v_cache, pos)
        a = linear(p.shared_attn.wo, o.reshape(B, 1, cfg.n_heads * cfg.head_dim))
    h = h + a @ p.inv_proj[inv]
    return h + mlp(p.shared_mlp, apply_norm(p.shared_ln2, h, cfg.norm),
                   cfg.act)


def _mamba_step(lp: MambaLayer, h: torch.Tensor, cfg, state=None
                ) -> torch.Tensor:
    y, _ = ssm_mod.mamba2_block(lp.mamba, apply_norm(lp.norm, h, cfg.norm),
                                cfg, state=state)
    return h + y


def _groups(cfg):
    """The layer index ranges between the shared-block invocations: (layers
    before invocation g, g) for each g, then the tail (g None)."""
    period = cfg.shared_attn_period
    n_inv = cfg.n_layers // period
    for g in range(n_inv):
        yield range(g * period, (g + 1) * period), g
    if cfg.n_layers > n_inv * period:
        yield range(n_inv * period, cfg.n_layers), None


def hybrid_forward(p: Hybrid, x: torch.Tensor, cfg, angles) -> torch.Tensor:
    """Train/prefill: each group of ``shared_attn_period`` Mamba2 layers,
    then the shared block on (h, the input embeddings)."""
    emb0 = x
    for layers, g in _groups(cfg):
        for i in layers:
            x = _run(_mamba_step, cfg, p.mamba_layers[i], x, cfg)
        if g is not None:
            x = _run(_shared_block, cfg, p, x, emb0, cfg, g, angles)
    return x


def hybrid_decode(p: Hybrid, x: torch.Tensor, cfg, angles, caches: dict,
                  pos: int) -> Tuple[torch.Tensor, dict]:
    emb0 = x
    ssm = caches["ssm"]
    for layers, g in _groups(cfg):
        for i in layers:
            x = _mamba_step(p.mamba_layers[i], x, cfg,
                            state={k: t[i] for k, t in ssm.items()})
        if g is not None:
            x = _shared_block(p, x, emb0, cfg, g, angles,
                              cache=(caches["k"][g], caches["v"][g]), pos=pos)
    return x, caches


def init_hybrid_caches(cfg, batch: int, seq: int, *, device=None) -> dict:
    """``ssm`` (Mamba2 states stacked over the layers) and ``k``/``v``
    (n_inv, B, S, Hkv, hd): one KV cache per shared-block invocation."""
    kv = init_kv_caches(cfg, batch, seq,
                        n_layers=cfg.n_layers // cfg.shared_attn_period,
                        device=device)
    return {"ssm": ssm_mod.init_mamba2_state(cfg, batch,
                                             n_layers=cfg.n_layers,
                                             device=device), **kv}


# ===========================================================================
# Whisper enc-dec
# ===========================================================================

class EncoderLayer(nn.Module):
    """ln1, attn, ln2, mlp, with biases."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = Attention(cfg, bias=True, device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, bias=True,
                       device=device)

    def init_(self, g: torch.Generator) -> None:
        self.attn.init_(g)
        self.mlp.init_(g)


class CrossDecoderLayer(nn.Module):
    """ln1, attn, lnx, xattn (cross-attention), ln2, mlp, with biases."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = Attention(cfg, bias=True, device=device)
        self.lnx = Norm(cfg.d_model, cfg.norm, device=device)
        self.xattn = Attention(cfg, bias=True, device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, bias=True,
                       device=device)

    def init_(self, g: torch.Generator) -> None:
        self.attn.init_(g)
        self.xattn.init_(g)
        self.mlp.init_(g)


class EncDec(nn.Module):
    """``encoder`` (n_encoder_layers), ``enc_ln``, ``enc_pos`` (F, d) bf16
    learned frame positions, ``decoder`` (n_layers)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.encoder = nn.ModuleList(EncoderLayer(cfg, device=device)
                                     for _ in range(cfg.n_encoder_layers))
        self.enc_ln = Norm(cfg.d_model, cfg.norm, device=device)
        self.enc_pos = _param((cfg.n_frontend_tokens, cfg.d_model),
                              torch.bfloat16, device)
        self.decoder = nn.ModuleList(CrossDecoderLayer(cfg, device=device)
                                     for _ in range(cfg.n_layers))

    def init_(self, g: torch.Generator) -> None:
        for lp in self.encoder:
            lp.init_(g)
        for lp in self.decoder:
            lp.init_(g)
        self.enc_pos.copy_(torch.randn(
            self.enc_pos.shape, generator=g, dtype=torch.float32,
            device=self.enc_pos.device).to(torch.bfloat16) * 0.02)


def _encoder_layer(lp: EncoderLayer, h: torch.Tensor, cfg) -> torch.Tensor:
    h = h + attention(lp.attn, apply_norm(lp.ln1, h, cfg.norm), cfg,
                      angles=None, causal=False)
    return h + mlp(lp.mlp, apply_norm(lp.ln2, h, cfg.norm), cfg.act)


def encoder_forward(p: EncDec, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames (B, F, d): precomputed frame embeddings (the reference's
    frontend is a stub) -> the encoder memory (B, F, d)."""
    x = frames + p.enc_pos[None].to(frames.dtype)
    for lp in p.encoder:
        x = _run(_encoder_layer, cfg, lp, x, cfg)
    return apply_norm(p.enc_ln, x, cfg.norm)


def _memory_kv(lp: CrossDecoderLayer, memory: torch.Tensor, cfg
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, F, _ = memory.shape
    k = linear(lp.xattn.wk, memory).reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
    v = linear(lp.xattn.wv, memory).reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def cross_kv(p: EncDec, memory: torch.Tensor, cfg
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each decoder layer's cross K/V of the memory: (L, B, F, Hkv, hd)."""
    ks, vs = zip(*(_memory_kv(lp, memory, cfg) for lp in p.decoder))
    return torch.stack(ks), torch.stack(vs)


def _crossdec_layer(lp: CrossDecoderLayer, h: torch.Tensor, cfg,
                    memory: torch.Tensor) -> torch.Tensor:
    h = h + attention(lp.attn, apply_norm(lp.ln1, h, cfg.norm), cfg,
                      angles=None, causal=True)
    h = h + attention(lp.xattn, apply_norm(lp.lnx, h, cfg.norm), cfg,
                      kv=_memory_kv(lp, memory, cfg))
    return h + mlp(lp.mlp, apply_norm(lp.ln2, h, cfg.norm), cfg.act)


def encdec_decoder(p: EncDec, x: torch.Tensor, cfg, memory: torch.Tensor
                   ) -> torch.Tensor:
    """Train/prefill decoder pass: causal self-attention, cross-attention
    over the memory, MLP."""
    for lp in p.decoder:
        x = _run(_crossdec_layer, cfg, lp, x, cfg, memory)
    return x


def encdec_decode(p: EncDec, x: torch.Tensor, cfg, caches: dict, pos: int
                  ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode over the self caches ``k``/``v`` (written in
    place) and the fixed cross K/V ``xk``/``xv``."""
    B = x.shape[0]
    F = caches["xk"].shape[2]
    for i, lp in enumerate(p.decoder):
        q, k, v = attention_qkv(lp.attn, apply_norm(lp.ln1, x, cfg.norm), cfg,
                                None)
        kc, vc = caches["k"][i], caches["v"][i]
        cache_update(kc, k, pos)
        cache_update(vc, v, pos)
        o = decode_attention(q, kc, vc, pos)
        x = x + linear(lp.attn.wo, o.reshape(B, 1, cfg.n_heads * cfg.head_dim))
        (qx,) = attention_qkv(lp.xattn, apply_norm(lp.lnx, x, cfg.norm), cfg,
                              None, kv=False)
        ox = decode_attention(qx, caches["xk"][i], caches["xv"][i], F - 1)
        x = x + linear(lp.xattn.wo,
                       ox.reshape(B, 1, cfg.n_heads * cfg.head_dim))
        x = x + mlp(lp.mlp, apply_norm(lp.ln2, x, cfg.norm), cfg.act)
    return x, caches


# ===========================================================================
# RWKV6 stack
# ===========================================================================

class RwkvLayer(nn.Module):
    """ln1, tm (time-mix), ln2, cm (channel-mix)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.tm = rwkv_mod.TimeMix(cfg, device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.cm = rwkv_mod.ChannelMix(cfg, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.tm.init_(g)
        self.cm.init_(g)


def _rwkv_layer(lp: RwkvLayer, h: torch.Tensor, cfg, state=None
                ) -> torch.Tensor:
    tm_state = cm_state = None
    if state is not None:
        tm_state = {"shift": state["tm_shift"], "wkv": state["wkv"]}
        cm_state = {"shift": state["cm_shift"]}
    y, _ = rwkv_mod.rwkv6_timemix(lp.tm, apply_norm(lp.ln1, h, cfg.norm), cfg,
                                  state=tm_state)
    h = h + y
    y, _ = rwkv_mod.rwkv6_channelmix(lp.cm, apply_norm(lp.ln2, h, cfg.norm),
                                     cfg, state=cm_state)
    return h + y


def rwkv_stack(layers: nn.ModuleList, x: torch.Tensor, cfg) -> torch.Tensor:
    for lp in layers:
        x = _run(_rwkv_layer, cfg, lp, x, cfg)
    return x


def rwkv_stack_decode(layers: nn.ModuleList, x: torch.Tensor, cfg,
                      caches: dict) -> Tuple[torch.Tensor, dict]:
    for i, lp in enumerate(layers):
        x = _rwkv_layer(lp, x, cfg, {k: t[i] for k, t in caches.items()})
    return x, caches


def init_rwkv_caches(cfg, batch: int, *, device=None) -> dict:
    return rwkv_mod.init_rwkv6_state(cfg, batch, n_layers=cfg.n_layers,
                                     device=device)
