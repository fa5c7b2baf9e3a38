"""RWKV-6 (Finch): attention-free time-mix with a data-dependent decay per
channel.  Port of ``repro.models.rwkv``.

Train/prefill runs the chunked parallel form (quadratic within a chunk,
the state carried from chunk to chunk, log-space cumulative decays); decode
is the O(1) recurrence, its token-shift and WKV states written in place.
Token-shift lerps with LoRA mixing coefficients, the decay w =
exp(-exp(·)), the bonus u for the current token, and a group norm per head,
as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (Linear, Norm, _param, layer_norm,
                                       linear)

CHUNK = 64


class LoRA(nn.Module):
    """``a`` (d, r) and ``b`` (r, out), bf16, N(0, 1)·0.01."""

    def __init__(self, d: int, r: int, out: int, *, device=None):
        super().__init__()
        self.a = _param((d, r), torch.bfloat16, device)
        self.b = _param((r, out), torch.bfloat16, device)

    def init_(self, g: torch.Generator) -> None:
        for w in (self.a, self.b):
            w.copy_(torch.randn(w.shape, generator=g, dtype=torch.float32,
                                device=w.device).to(w.dtype) * 0.01)


def _lora(p: LoRA, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ p.a) @ p.b


class TimeMix(nn.Module):
    """``mu_base`` (5, d) and ``mu_x`` (d,) lerp bases (bf16, 0.5),
    ``lora_mu`` (d -> 5d), ``wr``/``wk``/``wv``/``wg``/``wo``, ``w_base``
    (d,) fp32 decay base (-6), ``lora_w``, ``u`` (d,) fp32 bonus, ``gnorm``
    (layernorm over the head dim)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, r = cfg.d_model, cfg.rwkv_lora_dim
        self.mu_base = _param((5, d), torch.bfloat16, device)
        self.mu_x = _param((d,), torch.bfloat16, device)
        self.lora_mu = LoRA(d, r, 5 * d, device=device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, Linear(d, d, device=device))
        self.w_base = _param((d,), torch.float32, device)
        self.lora_w = LoRA(d, r, d, device=device)
        self.u = _param((d,), torch.float32, device)
        self.gnorm = Norm(cfg.rwkv_head_dim, "layernorm", device=device)
        with torch.no_grad():
            self.mu_base.fill_(0.5)
            self.mu_x.fill_(0.5)
            self.w_base.fill_(-6.0)

    def init_(self, g: torch.Generator) -> None:
        self.lora_mu.init_(g)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            getattr(self, name).init_(g)
        self.lora_w.init_(g)
        self.u.copy_(torch.randn(self.u.shape, generator=g,
                                 dtype=torch.float32, device=self.u.device)
                     * 0.1)


class ChannelMix(nn.Module):
    """``mu_k``, ``mu_r`` (d,) bf16 0.5; ``wk`` (d, ff), ``wv`` (ff, d),
    ``wr`` (d, d)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.mu_k = _param((d,), torch.bfloat16, device)
        self.mu_r = _param((d,), torch.bfloat16, device)
        self.wk = Linear(d, ff, device=device)
        self.wv = Linear(ff, d, device=device)
        self.wr = Linear(d, d, device=device)
        with torch.no_grad():
            self.mu_k.fill_(0.5)
            self.mu_r.fill_(0.5)

    def init_(self, g: torch.Generator) -> None:
        for lin in (self.wk, self.wv, self.wr):
            lin.init_(g)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The sequence shifted by one: ``prev`` (the previous segment's last
    token, decode) or zeros at t = 0."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, *, chunk: int = CHUNK,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV recurrence: S_t = diag(w_t) S_{t-1} + k_t v_tᵀ, o_t =
    r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ).  r, k, v, logw (B, L, H, D) (logw
    the log decay, <= 0); u (H, D).  Returns (o (B, L, H, D) in r's dtype,
    the final state (B, H, D, D) fp32)."""
    B, L, H, D = r.shape
    c = min(chunk, L)
    nc = -(-L // c)
    pad = nc * c - L
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    tri_lo = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    uf = u.float()
    S = (init_state if init_state is not None
         else torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device))
    outs = []
    for n in range(nc):
        sl = slice(n * c, (n + 1) * c)
        rb, kb, vb = (t[:, sl].float() for t in (r, k, v))     # (B, c, H, D)
        lwb = logw[:, sl].float()
        cum = torch.cumsum(lwb, dim=1)                          # inclusive
        cum_excl = cum - lwb
        # A[i, j, d] = exp(cum_excl[i, d] - cum[j, d]) for j < i: (B, c, c,
        # H, D) fp32, 67 MB a chunk at B 2, c 64, H 32, D 64; a layer's remat
        # recompute keeps every chunk's A and its products for the backward,
        # about 4-9 GB at S 4,096
        A = torch.where(tri_lo[None, :, :, None, None],
                        torch.exp(cum_excl[:, :, None] - cum[:, None]),
                        torch.zeros((), device=r.device))
        w_rk = (rb[:, :, None] * A * kb[:, None]).sum(-1)       # (B, i, j, H)
        o_intra = torch.matmul(w_rk.permute(0, 3, 1, 2),        # (B, H, i, j)
                               vb.transpose(1, 2))              # (B, H, j, e)
        o_bonus = (rb * uf * kb).sum(-1)[..., None] * vb
        r_dec = rb * torch.exp(cum_excl)
        o_inter = torch.matmul(r_dec.transpose(1, 2), S)       # (B, H, i, e)
        outs.append(o_intra.transpose(1, 2) + o_bonus
                    + o_inter.transpose(1, 2))
        k_dec = kb * torch.exp(cum[:, -1:] - cum)
        S = (S * torch.exp(cum[:, -1])[..., None]
             + torch.matmul(k_dec.permute(0, 2, 3, 1), vb.transpose(1, 2)))
    o = torch.cat(outs, dim=1)
    return o[:, :L].to(r.dtype), S


def rwkv6_timemix(p: TimeMix, x: torch.Tensor, cfg,
                  state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, L, d) -> (y, None).  With ``state`` (``shift`` (B, d), ``wkv``
    (B, H, D, D); decode) one recurrent step -> (y, state), the state
    written in place."""
    B, L, d = x.shape
    D = cfg.rwkv_head_dim
    H = d // D

    xs = _token_shift(x, state["shift"] if state is not None else None)
    dx = xs - x
    xx = x + dx * p.mu_x
    mus = _lora(p.lora_mu, xx).reshape(B, L, 5, d) + p.mu_base
    xw, xk, xv, xr, xg = (x + dx * mus[:, :, i] for i in range(5))

    rr = linear(p.wr, xr).reshape(B, L, H, D)
    kk = linear(p.wk, xk).reshape(B, L, H, D)
    vv = linear(p.wv, xv).reshape(B, L, H, D)
    gg = F.silu(linear(p.wg, xg))
    logw = -torch.exp(p.w_base + _lora(p.lora_w, xw).float())
    logw = logw.reshape(B, L, H, D)
    u = p.u.reshape(H, D)

    if state is None:
        o, _ = wkv6_chunked(rr, kk, vv, logw, u)
    else:
        S = state["wkv"]
        r1, k1, v1 = (t[:, 0].float() for t in (rr, kk, vv))   # (B, H, D)
        rku = (r1 * u * k1).sum(-1)                             # (B, H)
        o = (torch.matmul(r1[:, :, None], S)[:, :, 0]
             + rku[..., None] * v1)
        S.mul_(torch.exp(logw[:, 0])[..., None]).add_(
            k1[..., :, None] * v1[..., None, :])
        o = o[:, None].to(x.dtype)
        state["shift"].copy_(x[:, -1])

    o = layer_norm(o.reshape(B, -1, H, D), p.gnorm.w, p.gnorm.b)
    o = o.reshape(B, -1, d) * gg
    return linear(p.wo, o), state


def rwkv6_channelmix(p: ChannelMix, x: torch.Tensor, cfg,
                     state: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, L, d) -> (y, None), or (y, state) with ``state`` (``shift``,
    written in place)."""
    xs = _token_shift(x, state["shift"] if state is not None else None)
    dx = xs - x
    xk = x + dx * p.mu_k
    xr = x + dx * p.mu_r
    kk = torch.square(F.relu(linear(p.wk, xk)))
    o = torch.sigmoid(linear(p.wr, xr)) * linear(p.wv, kk)
    if state is not None:
        state["shift"].copy_(x[:, -1])
    return o, state


def init_rwkv6_state(cfg, batch: int, *, n_layers: int = 1,
                     device=None) -> dict:
    """Zero decode states with a leading (n_layers,) dim: ``tm_shift`` and
    ``cm_shift`` (L, B, d) bf16, ``wkv`` (L, B, H, D, D) fp32."""
    d, D = cfg.d_model, cfg.rwkv_head_dim
    H = d // D
    return {
        "tm_shift": torch.zeros((n_layers, batch, d), dtype=torch.bfloat16,
                                device=device),
        "cm_shift": torch.zeros((n_layers, batch, d), dtype=torch.bfloat16,
                                device=device),
        "wkv": torch.zeros((n_layers, batch, H, D, D), dtype=torch.float32,
                           device=device),
    }
