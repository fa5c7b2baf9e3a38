"""Neural layers: norms, RoPE and M-RoPE, attention (full-sequence and
cross-attention through the flash-attention kernel K8, single-token over a
KV cache), MLP, and the training loss.  Port of ``repro.models.layers``.

Parameters are ``nn.Module``s holding the reference's leaves under the
reference's names (``Linear.w`` is ``(d_in, d_out)`` and the product is
``x @ w``, so weights carried from the reference need no transpose); the
layer functions take a module where the reference takes its param dict.
Parameters are created without gradients (the serving path);
``steps.init_train_state`` turns them on.  Under autograd the attention is
``FlashAttention``: K8 forward, and the FlashAttention-2 backward in
PyTorch ops, chunk by chunk, the counterpart of XLA's autodiff of the
reference's rematerialised jnp scan (the reference has no backward kernel).
Left out: the GSPMD sharding hooks (``constrain_*``,
``set_activation_spec``; one card has nothing to shard).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.devices import matmul_tf32
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

def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim // 2), float32."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    return positions.float()[..., None] * inv


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """Standard RoPE: positions (B, S).  M-RoPE: positions (3, B, S); the
    head_dim // 2 frequency channels are cut into ``mrope_sections``
    (temporal, height, width), each taking its angles from one stream.  The
    slices are the reference's as written: sections that run past head_dim
    // 2 (the ``reduced()`` qwen2-vl's (16, 24, 24) at half 8) give stream 0
    every channel and the others none."""
    ang = _rope_angles(positions, head_dim, theta)
    if positions.ndim == 3 and mrope_sections is not None:
        secs, off = [], 0                             # ang (3, B, S, half)
        for i, s in enumerate(mrope_sections):
            secs.append(ang[i, ..., off:off + s])
            off += s
        return torch.cat(secs, dim=-1)                # (B, S, half)
    return ang


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
                    causal: bool = True, chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, Hkv, D), H % Hkv == 0 -> (B, Sq, H, D)
    in q's dtype.  K8 (``kernels.flash_attention``) on the card, its plain
    version on the CPU; under autograd (grad mode on and an input that
    requires grad) through ``FlashAttention``, whose backward works in
    query chunks of ``chunk`` rows (the reference's ``chunk_q``).  The
    reference's ``scale`` and ``q_offset`` are not taken: the kernel scales
    by D^-½ and aligns q and k at position 0, which is what every caller of
    the dense path passes."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, chunk)
    return _k8(q, k, v, causal=causal)


# fp32 bytes of one slab of scores in the backward: a slab is as many
# sequences of one query chunk as fit (at least one)
BACKWARD_SLAB_BYTES = 1 << 30


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: K8 forward; the FlashAttention-2 backward
    in PyTorch ops.  Saves q, k and v only; the backward recomputes the
    scores per query chunk over the keys that chunk can see, so its peak is
    one slab's (rows, S) fp32 scores, never O(S²) for the whole batch.

    Products run on fp32 copies.  For bf16 inputs they may use TF32 (the
    operands of q·kᵀ, dO·Vᵀ and Pᵀ·dO are bf16 values, exact in TF32; dS's
    products round dS to TF32's 10 bits, far inside the bf16 gradient's
    8); for fp32 inputs TF32 is off."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.chunk = causal, chunk
        return _k8(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with matmul_tf32(q.dtype != torch.float32):
            dq, dk, dv = attention_backward(q, k, v, do, causal=ctx.causal,
                                            chunk=ctx.chunk)
        return dq, dk, dv, None, None


def attention_backward(q, k, v, do, *, causal: bool, chunk: int):
    """(dq, dk, dv) of softmax(q·kᵀ·D^-½)·v with cotangent ``do``, in q's,
    k's and v's dtypes.  Per query chunk: S over the keys it sees (causal
    chunks stop at their last row), P the row softmax in fp32, dV += Pᵀ·dO
    (P rounded to v's dtype, as the forward rounds it), dP = dO·Vᵀ, Δ =
    rowsum(P∘dP), dS = P∘(dP − Δ), dQ = dS·K·D^-½, dK += dSᵀ·Q·D^-½; the
    query group of each key head is one row block of the products, so dK
    and dV sum over it (GQA).

    Δ is FlashAttention-2's rowsum(dO∘O), taken from the fp32 P and dP of
    the whole row, which each chunk holds: from a bf16 O its rounding does
    not cancel in dS's row sum, and where dQ is small (trained query and
    key weights) it made their gradients 0.1 off."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    # (B, Hkv, G, S, D) fp32: query head h reads key head h // G
    qf, dof = (t.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
               for t in (q, do))
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))   # (B, Hkv, Sk, D)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    cq = max(1, min(chunk, Sq))
    rows = max(1, BACKWARD_SLAB_BYTES // (4 * H * cq * max(Sk, 1)))
    for i0 in range(0, Sq, cq):
        i1 = min(i0 + cq, Sq)
        nk = min(i1, Sk) if causal else Sk
        if nk == 0:
            continue
        c = i1 - i0
        for b0 in range(0, B, rows):
            bs = slice(b0, min(b0 + rows, B))
            nb = bs.stop - b0

            def rows_of(t):
                return t[bs, :, :, i0:i1].reshape(nb, Hkv, G * c, -1)

            qc, doc = rows_of(qf), rows_of(dof)
            kc, vc = kf[bs, :, :nk], vf[bs, :, :nk]
            s = torch.matmul(qc, kc.transpose(-1, -2)).mul_(scale)
            if causal:
                # rows i0..i1 see keys <= their own position
                qpos = torch.arange(i0, i1, device=q.device).repeat(G)
                s.masked_fill_(qpos[:, None] < torch.arange(nk, device=q.device),
                               NEG_INF)
            p = torch.softmax(s, dim=-1)
            del s
            dv[bs, :, :nk] += torch.matmul(
                p.to(v.dtype).float().transpose(-1, -2), doc)
            dp = torch.matmul(doc, vc.transpose(-1, -2))
            ds = dp.sub_((dp * p).sum(-1, keepdim=True)).mul_(p)
            del p
            dq[bs, :, :, i0:i1] = torch.matmul(ds, kc).mul_(scale).reshape(
                nb, Hkv, G, c, D)
            dk[bs, :, :nk] += torch.matmul(ds.transpose(-1, -2), qc).mul_(scale)
            del ds
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


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
    """wq, wk, wv, wo (bf16), and qnorm/knorm with ``cfg.qk_norm``.  The
    projections read ``d_in`` features (``cfg.d_model`` unless given:
    zamba2's shared block reads 2·d_model) and ``wo`` writes d_model."""

    def __init__(self, cfg, *, d_in: Optional[int] = None, bias: bool = False,
                 device=None):
        super().__init__()
        d_in = d_in or cfg.d_model
        hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        kw = dict(bias=bias, device=device)
        self.wq = Linear(d_in, hq, **kw)
        self.wk = Linear(d_in, hkv, **kw)
        self.wv = Linear(d_in, hkv, **kw)
        self.wo = Linear(hq, cfg.d_model, **kw)
        if cfg.qk_norm:
            self.qnorm = Norm(cfg.head_dim, "rmsnorm", device=device)
            self.knorm = Norm(cfg.head_dim, "rmsnorm", device=device)

    def init_(self, g: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.init_(g)


def attention_qkv(p: Attention, x: torch.Tensor, cfg,
                  angles: Optional[torch.Tensor], *, kv: bool = True
                  ) -> Tuple[torch.Tensor, ...]:
    """(q, k, v) of ``x``; (q,) alone with ``kv=False`` (a cross-attention
    query, whose K/V come from elsewhere)."""
    B, S, _ = x.shape
    q = linear(p.wq, x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.qnorm.w)
    if angles is not None:
        q = apply_rope(q, angles)
    if not kv:
        return (q,)
    k = linear(p.wk, x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = linear(p.wv, x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rms_norm(k, p.knorm.w)
    if angles is not None:
        k = apply_rope(k, angles)
    return q, k, v


def attention(p: Attention, x: torch.Tensor, cfg, *, angles=None,
              causal: bool = True,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  ``kv`` (k, v), each (B,
    Sk, Hkv, hd), replaces the self K/V and makes it non-causal: whisper's
    cross-attention over the encoder memory."""
    B, S, _ = x.shape
    if kv is None:
        q, k, v = attention_qkv(p, x, cfg, angles)
    else:
        (q,), (k, v) = attention_qkv(p, x, cfg, angles, kv=False), kv
        causal = False
    o = flash_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
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

    def init_(self, g: torch.Generator) -> None:
        for name in ("wg", "wu", "wd"):
            if hasattr(self, name):
                getattr(self, name).init_(g)


def mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        h = F.silu(linear(p.wg, x)) * linear(p.wu, x)
    else:
        h = F.gelu(linear(p.wu, x), approximate="tanh")   # jax.nn.gelu
    return linear(p.wd, h)


# ---------------------------------------------------------------------------
# Chunked softmax cross-entropy (O(chunk·V) memory)
# ---------------------------------------------------------------------------

def _xent_chunk(hc: torch.Tensor, w_out: torch.Tensor, lc: torch.Tensor,
                mc: torch.Tensor) -> torch.Tensor:
    logits = (hc @ w_out).float()                       # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None])[..., 0]
    return ((lse - gold) * mc).sum()


def chunked_softmax_xent(h: torch.Tensor, w_out: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 512,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h (B, S, d); w_out (d, V); labels (B, S) ints.  Returns the mean NLL
    over the mask (fp32 0-d).  Each chunk of ``chunk`` positions is
    rematerialised in the backward (``checkpoint``, the counterpart of the
    reference's ``nothing_saveable`` scan body), so the (B, chunk, V) logits,
    never (B, S, V), are the peak activation."""
    B, S, _ = h.shape
    labels = labels.long()
    mask = (torch.ones((B, S), dtype=torch.float32, device=h.device)
            if mask is None else mask.float())
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i0 in range(0, S, chunk):
        sl = slice(i0, i0 + chunk)
        args = (h[:, sl], w_out, labels[:, sl], mask[:, sl])
        tot = tot + (checkpoint(_xent_chunk, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else _xent_chunk(*args))
    return tot / torch.clamp(mask.sum(), min=1.0)
