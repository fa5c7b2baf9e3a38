"""Mamba2 (state-space duality) block: the chunked scan for train/prefill,
the O(1) recurrent step for decode.  Port of ``repro.models.ssm``.

The sequence is cut into chunks of ``CHUNK``; within a chunk the quadratic
(masked-attention-like) form runs as dense products, and the state is
carried from chunk to chunk by a loop.  The reference's three-operand
einsums are written as an elementwise product followed by one ``matmul``
(``torch.einsum`` would contract them left to right and build a (B, nc, H,
c, c, P) intermediate: 8.6 GB a sequence at zamba2's width), and every
operand is cast where jnp's promotion casts it (bf16 × fp32 is fp32; bf16 ×
bf16 stays bf16).  Decode writes the conv and SSM states in place, as the
KV caches are written.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, Norm, _param, linear, rms_norm

CHUNK = 128


class Mamba2(nn.Module):
    """The reference's leaves: ``z_proj``, ``x_proj``, ``B_proj``,
    ``C_proj``, ``dt_proj`` (bf16 linears), ``conv_w`` (K, d_in) and
    ``conv_b``, ``conv_bc_w`` (K, 2N) and ``conv_bc_b`` (bf16), ``A_log``,
    ``D``, ``dt_bias`` (H,) fp32, ``norm`` (rmsnorm over d_in), ``out_proj``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        N, K = cfg.ssm_state, cfg.ssm_conv
        H = d_in // cfg.ssm_head_dim
        self.z_proj = Linear(d, d_in, device=device)
        self.x_proj = Linear(d, d_in, device=device)
        self.B_proj = Linear(d, N, device=device)
        self.C_proj = Linear(d, N, device=device)
        self.dt_proj = Linear(d, H, device=device)
        self.conv_w = _param((K, d_in), torch.bfloat16, device)
        self.conv_b = _param((d_in,), torch.bfloat16, device)
        self.conv_bc_w = _param((K, 2 * N), torch.bfloat16, device)
        self.conv_bc_b = _param((2 * N,), torch.bfloat16, device)
        self.A_log = _param((H,), torch.float32, device)
        self.D = _param((H,), torch.float32, device)
        self.dt_bias = _param((H,), torch.float32, device)
        self.norm = Norm(d_in, "rmsnorm", device=device)
        self.out_proj = Linear(d_in, d, device=device)
        with torch.no_grad():
            self.conv_b.zero_()
            self.conv_bc_b.zero_()
            self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
            self.D.fill_(1.0)
            self.dt_bias.copy_(torch.log(torch.expm1(torch.full((H,), 0.01))))

    def init_(self, g: torch.Generator) -> None:
        for lin in (self.z_proj, self.x_proj, self.B_proj, self.C_proj,
                    self.dt_proj):
            lin.init_(g)
        for w in (self.conv_w, self.conv_bc_w):
            w.copy_(torch.randn(w.shape, generator=g, dtype=torch.float32,
                                device=w.device).to(w.dtype) * 0.2)
        self.out_proj.init_(g)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x (B, L, Cd); w (K, Cd).  Returns (y, the
    trailing K - 1 inputs: the next step's state)."""
    K, L = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:L] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + L] * w[i]
    y = F.silu(y + b)
    return y, xp[:, xp.shape[1] - (K - 1):]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) -> (..., L, L): out[i, j] = Σ_{j < s <= i} x[s], -inf
    above the diagonal (the exp-decay mask)."""
    L = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def mamba2_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = CHUNK,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  xh (B, L, H, P) value heads; dt (B, L, H) (after
    softplus); A (H,) negative; Bm, Cm (B, L, N) (one group, shared by the
    heads).  Returns (y (B, L, H, P) in the promoted dtype, the final state
    (B, H, P, N) fp32)."""
    Bb, L, H, P = xh.shape
    N = Bm.shape[-1]
    c = min(chunk, L)
    nc = -(-L // c)
    pad = nc * c - L
    if pad:
        xh, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                          for t in (xh, dt, Bm, Cm))
    xc = xh.reshape(Bb, nc, c, H, P)
    dtc = dt.reshape(Bb, nc, c, H)
    Bc = Bm.reshape(Bb, nc, c, N)
    Cc = Cm.reshape(Bb, nc, c, N)

    dA = dtc * A                                    # (B, nc, c, H)
    dA_cum = torch.cumsum(dA, dim=2)

    # intra-chunk: W[b,n,h,i,j] = (C_i·B_j) L[h,i,j], y_i = Σ_j W x_j dt_j
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))           # (B,nc,H,c,c)
    CB = torch.matmul(Cc, Bc.transpose(-1, -2))                 # (B,nc,c,c)
    W = CB[:, :, None] * Lmat
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)          # (B,nc,H,c,P)
    y_diag = torch.matmul(W, xdt.to(W.dtype)).permute(0, 1, 3, 2, 4)

    # chunk states, fp32
    decay_states = torch.exp(dA_cum[:, :, -1:] - dA_cum)        # (B,nc,c,H)
    xw = ((decay_states * dtc).float()[..., None] * xc.float())
    states = torch.matmul(xw.permute(0, 1, 3, 4, 2),            # (B,nc,H,P,c)
                          Bc.float()[:, :, None])               # (B,nc,H,P,N)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1])                   # (B, nc, H)
    s = (init_state if init_state is not None
         else torch.zeros((Bb, H, P, N), dtype=torch.float32,
                          device=xh.device))
    entering = []
    for n in range(nc):
        entering.append(s)
        s = s * chunk_decay[:, n, :, None, None] + states[:, n]
    states_in = torch.stack(entering, dim=1)                    # (B,nc,H,P,N)

    # the entering state's contribution to each position
    state_decay = torch.exp(dA_cum)                             # (B,nc,c,H)
    y_off = torch.matmul(Cc.float()[:, :, None],                # (B,nc,1,c,N)
                         states_in.transpose(-1, -2))           # (B,nc,H,c,P)
    y_off = y_off.permute(0, 1, 3, 2, 4) * state_decay[..., None]
    y = (y_diag + y_off).reshape(Bb, nc * c, H, P)
    return y[:, :L], s


def mamba2_block(p: Mamba2, x: torch.Tensor, cfg,
                 state: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """The Mamba2 block on x (B, L, d) -> (y, None).  With ``state``
    (``conv_x``, ``conv_bc``, ``ssm``; decode, L 1) one recurrent step ->
    (y, state), the state written in place."""
    B, L, d = x.shape
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim

    z = linear(p.z_proj, x)
    xc = linear(p.x_proj, x)
    bc = torch.cat([linear(p.B_proj, x), linear(p.C_proj, x)], dim=-1)
    dt = linear(p.dt_proj, x)
    A = -torch.exp(p.A_log)

    if state is None:
        xc, _ = _causal_conv(xc, p.conv_w, p.conv_b)
        bc, _ = _causal_conv(bc, p.conv_bc_w, p.conv_bc_b)
        Bm, Cm = bc.chunk(2, dim=-1)
        dt = F.softplus(dt.float() + p.dt_bias)
        y, _ = mamba2_scan(xc.reshape(B, L, H, P), dt, A, Bm, Cm)
        y = y + p.D[:, None] * xc.reshape(B, L, H, P)
        y = y.reshape(B, L, d_in).to(x.dtype)
        return linear(p.out_proj, rms_norm(y * F.silu(z), p.norm.w)), None

    xc, conv_x = _causal_conv(xc, p.conv_w, p.conv_b, state["conv_x"])
    bc, conv_bc = _causal_conv(bc, p.conv_bc_w, p.conv_bc_b,
                               state["conv_bc"])
    Bm, Cm = bc.chunk(2, dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)[:, 0]               # (B, H)
    xh = xc.reshape(B, H, P)
    dAe = torch.exp(dt * A)
    dBx = ((dt[..., None] * xh.float())[..., None]
           * Bm[:, 0].float()[:, None, None, :])                # (B,H,P,N)
    ssm = state["ssm"].mul_(dAe[..., None, None]).add_(dBx)
    y = torch.matmul(ssm, Cm[:, 0].float()[:, None, :, None])[..., 0]
    y = y + p.D[:, None] * xh
    y = y.reshape(B, 1, d_in).to(x.dtype)
    state["conv_x"].copy_(conv_x)
    state["conv_bc"].copy_(conv_bc)
    return linear(p.out_proj, rms_norm(y * F.silu(z), p.norm.w)), state


def init_mamba2_state(cfg, batch: int, *, n_layers: int = 1,
                      device=None) -> dict:
    """Zero decode states, each with a leading (n_layers,) dim: ``conv_x``
    (L, B, K - 1, d_in) and ``conv_bc`` (L, B, K - 1, 2N) bf16, ``ssm``
    (L, B, H, P, N) fp32."""
    d_in = cfg.ssm_expand * cfg.d_model
    N, K = cfg.ssm_state, cfg.ssm_conv
    H, P = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim
    z = dict(device=device)
    return {
        "conv_x": torch.zeros((n_layers, batch, K - 1, d_in),
                              dtype=torch.bfloat16, **z),
        "conv_bc": torch.zeros((n_layers, batch, K - 1, 2 * N),
                               dtype=torch.bfloat16, **z),
        "ssm": torch.zeros((n_layers, batch, H, P, N), dtype=torch.float32,
                           **z),
    }
