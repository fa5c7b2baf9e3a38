"""Mixture-of-Experts FFN with sort-based dispatch.  Port of
``repro.models.moe``.  While a mesh is set (``moe_sharded.set_moe_mesh``)
``moe_ffn`` hands over to ``moe_sharded.moe_ffn_sharded``, as the
reference does.

Tokens are routed top-k, argsorted by expert (stable) and gathered into an
(E, C, d) buffer with capacity C per expert; a token past its expert's
capacity is dropped there.  No (T, E, C) one-hot tensor is built.

Determinism.  The reference scatter-adds each slot's gated output into a
zero (T, d) buffer; XLA applies the updates in slot order, so a token sums
its experts' outputs in ascending expert id, rounding after each add.  The
port gathers instead: each token reads its k slots in ascending slot order
(dropped ones read a zero row) and adds them in sequence, which gives the
same sums without a scatter.  Dispatch and combine are autograd Functions
whose backwards are again fixed-order gathers over the inverse map (token ->
its k slots, slot -> its token): autograd's backward of a row gather is an
accumulating ``index_put_``, which uses atomics on the card, so a replayed
step would not be bit-equal.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import MLP, _param, mlp


class MoE(nn.Module):
    """``router`` (d, E) fp32; ``wg``, ``wu`` (E, d, ff) and ``wd`` (E, ff,
    d) bf16; ``shared`` (an ``MLP`` of width 2·ff·n_shared_experts) when the
    config has shared experts."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _param((d, E), torch.float32, device)
        self.wg = _param((E, d, ff), torch.bfloat16, device)
        self.wu = _param((E, d, ff), torch.bfloat16, device)
        self.wd = _param((E, ff, d), torch.bfloat16, device)
        if cfg.n_shared_experts:
            self.shared = MLP(d, 2 * ff * cfg.n_shared_experts, cfg.act,
                              device=device)

    def init_(self, g: torch.Generator) -> None:
        """The reference's ``init_moe``: router N(0, 1)·0.02 in fp32;
        experts N(0, 1)·d^-½ (wg, wu) and ·ff^-½ (wd) in fp32, cast to
        bf16."""
        def normal(t):
            return torch.randn(t.shape, generator=g, dtype=torch.float32,
                               device=t.device)

        E, d, ff = self.wg.shape
        self.router.copy_(normal(self.router) * 0.02)
        self.wg.copy_(normal(self.wg) * float(d) ** -0.5)
        self.wu.copy_(normal(self.wu) * float(d) ** -0.5)
        self.wd.copy_(normal(self.wd) * float(ff) ** -0.5)
        if hasattr(self, "shared"):
            self.shared.init_(g)


def _capacity(T: int, top_k: int, E: int, factor: float) -> int:
    """Slots per expert: T·k·factor / E rounded up to 128 (the reference's
    TPU alignment, kept: it decides which tokens are dropped)."""
    c = int(T * top_k * factor / E)
    return max(128, -(-c // 128) * 128)


def _zero_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


class _Dispatch(torch.autograd.Function):
    """xe[s] = xf[slot_token[s]] (a zero row where the slot is empty, token
    index T); the backward sums each token's k slot gradients in the order
    of ``token_slots`` (empty entries, index E·C, read zero)."""

    @staticmethod
    def forward(ctx, xf, slot_token, token_slots):
        ctx.save_for_backward(token_slots)
        return _zero_row(xf)[slot_token]

    @staticmethod
    def backward(ctx, dxe):
        (token_slots,) = ctx.saved_tensors
        pad = _zero_row(dxe)
        dx = pad[token_slots[:, 0]]
        for j in range(1, token_slots.shape[1]):
            dx = dx + pad[token_slots[:, j]]
        return dx, None, None


class _Combine(torch.autograd.Function):
    """y[t] = Σ_j ye[token_slots[t, j]] · gates[t, j] (gates cast to ye's
    dtype, each product and each partial sum rounded to it, j ascending);
    the backward gathers dy back to each slot from its token (``slot_token``,
    ``slot_j``) and reduces the gates' gradient per token."""

    @staticmethod
    def forward(ctx, ye, gates, token_slots, slot_token, slot_j):
        pad = _zero_row(ye)
        g = gates.to(ye.dtype)
        y = ye.new_zeros((token_slots.shape[0], ye.shape[1]))
        for j in range(token_slots.shape[1]):
            y = y + pad[token_slots[:, j]] * g[:, j:j + 1]
        ctx.save_for_backward(ye, gates, token_slots, slot_token, slot_j)
        return y

    @staticmethod
    def backward(ctx, dy):
        ye, gates, token_slots, slot_token, slot_j = ctx.saved_tensors
        T = token_slots.shape[0]
        occupied = slot_token < T
        tok = slot_token.clamp(max=T - 1)
        g_slot = torch.where(occupied, gates.to(ye.dtype)[tok, slot_j],
                             torch.zeros((), dtype=ye.dtype, device=ye.device))
        dye = dy[tok] * g_slot[:, None]
        pad = _zero_row(ye)
        dg = torch.stack([(pad[token_slots[:, j]].float() * dy.float()).sum(-1)
                          for j in range(token_slots.shape[1])], dim=1)
        return dye, dg.to(gates.dtype), None, None, None


def route(logits: torch.Tensor, k: int, C: int):
    """Top-k routing of (T, E) fp32 router logits with capacity C per
    expert.  Returns (probs, top_p (T, k) renormalised, top_e (T, k),
    token_slots (T, k): each pair's slot e·C + rank, or E·C where dropped,
    sorted ascending per token, with ``perm`` the top-k position of each,
    slot_token (E·C,): the token in each slot or T, slot_j: that pair's
    column in ``token_slots``)."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    pe = top_e.reshape(-1)                                   # (T·k,)
    order = torch.sort(pe, stable=True).indices
    se = pe[order]
    # (a scatter-add, not bincount: it also runs on meta tensors, which the
    # dry run's accounting uses)
    counts = torch.zeros(E, dtype=pe.dtype, device=pe.device).scatter_add_(
        0, pe, torch.ones_like(pe))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=pe.device) - starts[se]
    slot_sorted = torch.where(rank < C, se * C + rank,
                              torch.full_like(rank, E * C))
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted                                # a permutation
    token_slots, perm = torch.sort(slot.reshape(T, k), dim=1)
    # the inverse map: slot s = e·C + r holds sorted pair starts[e] + r
    # while r < min(counts[e], C); that pair's token, and its column
    s = torch.arange(E * C, device=pe.device)
    e_s, r_s = s // C, s % C
    occupied = r_s < counts[e_s]
    pair = order[torch.where(occupied, starts[e_s] + r_s,
                             torch.zeros_like(s))]
    slot_token = torch.where(occupied, pair // k, torch.full_like(s, T))
    col = torch.searchsorted(token_slots[slot_token.clamp(max=T - 1)],
                             s[:, None])[:, 0]
    slot_j = torch.where(occupied, col, torch.zeros_like(col))
    return probs, top_p, top_e, token_slots, perm, slot_token, slot_j


def moe_ffn(p: MoE, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux loss).  Top-k routing, capacity dropping,
    experts as three batched products over (E, C, ·), the Switch-style load
    balance loss.  Under a mesh, ``moe_sharded.moe_ffn_sharded``."""
    from repro_torch.models import moe_sharded
    if moe_sharded.moe_mesh() is not None:
        return moe_sharded.moe_ffn_sharded(p, x, cfg)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = _capacity(T, k, E, cfg.capacity_factor)
    xf = x.reshape(T, d)

    logits = xf.float() @ p.router                           # (T, E)
    probs, top_p, top_e, token_slots, perm, slot_token, slot_j = route(
        logits, k, C)
    me = probs.mean(0)
    ce = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = cfg.router_aux_coef * E * (me * ce).sum()

    xe = _Dispatch.apply(xf, slot_token, token_slots).reshape(E, C, d)
    h = F.silu(torch.bmm(xe, p.wg)) * torch.bmm(xe, p.wu)
    ye = torch.bmm(h, p.wd).reshape(E * C, d)
    y = _Combine.apply(ye, top_p.gather(1, perm), token_slots, slot_token,
                       slot_j)
    if hasattr(p, "shared"):
        y = y + mlp(p.shared, xf, cfg.act)
    return y.reshape(B, S, d), aux
