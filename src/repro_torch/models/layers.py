"""Neural layers of the dense decoder: norms, RoPE, attention (full-sequence
through the flash-attention kernel K8, single-token over a KV cache), MLP.
Port of the dense subset of ``repro.models.layers``.

Parameters are ``nn.Module``s holding the reference's leaves under the
reference's names (``Linear.w`` is ``(d_in, d_out)`` and the product is
``x @ w``, so weights carried from the reference need no transpose); the
layer functions take a module where the reference takes its param dict.
Parameters do not require gradients: the port serves, and K8 has no
backward yet.  Left out: the GSPMD sharding hooks (``constrain_*``,
``set_activation_spec``; one card has nothing to shard) and the training
loss ``chunked_softmax_xent``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention as _k8
from repro_torch.kernels.ref import NEG_INF


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


class Norm(nn.Module):
    """``w`` (and ``b`` for layernorm), fp32, ones and zeros."""

    def __init__(self, d: int, kind: str, *, device=None):
        super().__init__()
        self.w = _param((d,), torch.float32, device)
        nn.init.ones_(self.w)
        if kind != "rmsnorm":
            self.b = _param((d,), torch.float32, device)
            nn.init.zeros_(self.b)


def apply_norm(p: Norm, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p.w)
    return layer_norm(x, p.w, p.b)


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """``w`` (d_in, d_out) and an optional bias ``b`` (d_out,), bf16 by
    default; ``init_params`` fills them."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        if bias:
            self.b = _param((d_out,), dtype, device)

    def init_(self, g: torch.Generator) -> None:
        """The reference's ``init_linear``: N(0, 1) drawn in fp32, cast to
        the weight's dtype, times 1/√d_in in that dtype; the bias zero."""
        draw = torch.randn(self.w.shape, generator=g, dtype=torch.float32,
                           device=self.w.device)
        self.w.copy_(draw.to(self.w.dtype) * (1.0 / math.sqrt(self.w.shape[0])))
        if hasattr(self, "b"):
            self.b.zero_()


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if hasattr(p, "b"):
        y = y + p.b
    return y


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """positions (B, S) -> angles (B, S, head_dim // 2), float32."""
    if mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE (the vlm family) is not ported yet: ROADMAP Queue A, "
            "item 9 (the other model families)")
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); angles: (B, S, D//2).  Rotate-half convention."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, Hkv, D), H % Hkv == 0 -> (B, Sq, H, D)
    in q's dtype.  K8 (``kernels.flash_attention``) on the card, its plain
    version on the CPU.  The reference's chunk sizes, ``scale`` and
    ``q_offset`` are not taken: the kernel scales by D^-½ and aligns q and k
    at position 0, which is what every caller of the dense path passes."""
    return _k8(q, k, v, causal=causal)


def cache_update(cache: torch.Tensor, new: torch.Tensor, pos: int
                 ) -> torch.Tensor:
    """Write ``new`` (B, 1, H, D) at seq position ``pos`` of the cache
    (B, S, H, D), cast to the cache's dtype.  In place (a slice assignment;
    the reference's one-hot select only serves a seq-sharded cache);
    returns the cache."""
    cache[:, pos] = new[:, 0].to(cache.dtype)
    return cache


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Single-token attention over a KV cache.  q: (B, 1, H, D); caches
    (B, S, Hkv, D); attends to cache indices <= ``pos``.  fp32 scores and
    softmax; the probabilities are rounded to the cache's dtype before P·V,
    as in the reference."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * (1.0 / math.sqrt(D))
    mask = torch.arange(S, device=q.device) <= pos
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + flash/decode core)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """wq, wk, wv, wo (bf16), and qnorm/knorm with ``cfg.qk_norm``."""

    def __init__(self, cfg, *, bias: bool = False, device=None):
        super().__init__()
        d = cfg.d_model
        hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        kw = dict(bias=bias, device=device)
        self.wq = Linear(d, hq, **kw)
        self.wk = Linear(d, hkv, **kw)
        self.wv = Linear(d, hkv, **kw)
        self.wo = Linear(hq, d, **kw)
        if cfg.qk_norm:
            self.qnorm = Norm(cfg.head_dim, "rmsnorm", device=device)
            self.knorm = Norm(cfg.head_dim, "rmsnorm", device=device)


def attention_qkv(p: Attention, x: torch.Tensor, cfg,
                  angles: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = linear(p.wq, x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = linear(p.wk, x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = linear(p.wv, x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.qnorm.w)
        k = rms_norm(k, p.knorm.w)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def attention(p: Attention, x: torch.Tensor, cfg, *, angles=None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (prefill).  The reference's ``kv``
    override (whisper's cross-attention) waits for the encdec family."""
    B, S, _ = x.shape
    q, k, v = attention_qkv(p, x, cfg, angles)
    o = flash_attention(q, k, v, causal=causal)
    return linear(p.wo, o.reshape(B, S, cfg.n_heads * cfg.head_dim))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated (``silu``: wg, wu, wd) or plain (``gelu``: wu, wd)."""

    def __init__(self, d_model: int, d_ff: int, act: str, *,
                 bias: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = dict(bias=bias, dtype=dtype, device=device)
        if act == "silu":
            self.wg = Linear(d_model, d_ff, **kw)
        self.wu = Linear(d_model, d_ff, **kw)
        self.wd = Linear(d_ff, d_model, **kw)


def mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        h = F.silu(linear(p.wg, x)) * linear(p.wu, x)
    else:
        h = F.gelu(linear(p.wu, x), approximate="tanh")   # jax.nn.gelu
    return linear(p.wd, h)
