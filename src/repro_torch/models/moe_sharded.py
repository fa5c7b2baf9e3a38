"""The MoE FFN on a (data x model) mesh: per-data-shard routing and
model-sharded experts.  Port of ``repro.models.moe_sharded``.

The reference runs this as a ``shard_map`` body on every (data, model)
device.  The port runs it under one controller, as ``core/distributed.py``
runs the pod index: the mesh is a ``PodMesh`` of ``torch.device``s, and
data shard ``i`` and model shard ``j`` compute on the device at that mesh
position (K shards may share one device).  The contract, from the
reference:

  * the batch is split over the data axes when they divide it; otherwise
    every data shard takes the whole batch;
  * capacity is per shard, from the shard's T_loc tokens;
  * each data shard routes its own tokens (fp32 router, softmax, top-k,
    renormalise) -- the reference repeats this on every model shard, and
    computing it once per data shard gives the same values;
  * model shard ``j`` computes only experts ``j·E_loc .. (j+1)·E_loc - 1``,
    through ``moe.py``'s dispatch and combine Functions (fixed-order
    gathers, gather backwards: a replayed step is bit-equal);
  * with ``cfg.fsdp`` the expert weights are split over ``"data"`` on
    their second dim (``launch/sharding.py``) and gathered inside the body;
  * the partial outputs are summed over ``model`` in ascending ``j`` (the
    reference's psum); ``aux`` is the mean over ``model`` (equal values:
    the routing is the data shard's), then over the data shards;
  * the shared expert, where the config has one, is applied to ``x``.

A deliberate difference: the reference gathers the FSDP weights over every
data axis, ``("pod", "data")``, but ``launch/sharding.py`` splits them over
``"data"`` alone, so on a mesh with a ``pod`` axis the reference's gathered
weights have the wrong width and its einsum raises.  The port gathers over
``"data"``, the axis the weights are split on (ROADMAP, Queue C).

Every cross-shard step is recorded in the collective ledger
(``core/collectives.py``), once a call, as one device of the reference's
program sees it: the all-reduce of the (T_loc, d) output over ``model``,
the three FSDP all-gathers (and, in the backward, the reduce-scatters of
their gradients) and the two all-reduces of ``aux``.  The cotangent of the
sum over ``model`` is the data shard's own cotangent on every model shard:
it needs no communication.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.models.layers import mlp
from repro_torch.models.moe import (MoE, _capacity, _Combine, _Dispatch,
                                    route)

_MOE_MESH = None  # (mesh, data_axes) or None


def set_moe_mesh(mesh, data_axes) -> None:
    """Route every ``moe.moe_ffn`` call through ``moe_ffn_sharded`` on
    ``mesh`` (a ``core/distributed.PodMesh`` with a ``"model"`` axis), the
    batch split over ``data_axes``; ``None`` turns it off."""
    global _MOE_MESH
    _MOE_MESH = (mesh, tuple(data_axes)) if mesh is not None else None


def moe_mesh():
    return _MOE_MESH


def shard_grid(mesh, data_axes) -> np.ndarray:
    """(n_data, n_model) object array: the device of data shard ``i``
    (row-major over ``data_axes``) and model shard ``j``; an axis in
    neither replicates, and its first device computes."""
    names = list(mesh.axis_names)
    order = [names.index(a) for a in data_axes] + [names.index("model")]
    rest = [i for i in range(len(names)) if i not in order]
    grid = np.transpose(mesh.devices, order + rest)
    grid = grid[(Ellipsis,) + (0,) * len(rest)] if rest else grid
    return np.asarray(grid, dtype=object).reshape(-1, grid.shape[-1])


class _GatherOverData(torch.autograd.Function):
    """The FSDP all-gather over ``"data"``: one model shard's expert slice
    ``w`` (E_loc, d, ff) put together from its ``n`` data slices along dim
    1.  Under one controller those slices are views of one tensor, so the
    gather is a copy; it is recorded as the all-gather it stands for, and
    its gradient as the reduce-scatter (each data slice's sum over the data
    shards, which autograd's accumulation into the weight performs)."""

    @staticmethod
    def forward(ctx, w, n: int, rec: bool):
        ctx.n, ctx.rec = n, rec
        step = w.shape[1] // n
        out = torch.cat([w[:, s * step:(s + 1) * step] for s in range(n)],
                        dim=1)
        if rec:
            collectives.record("all-gather", collectives.tensor_bytes(out))
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.rec:
            collectives.record("reduce-scatter",
                               collectives.tensor_bytes(g) // ctx.n)
        return g, None, None


def _expert_weights(p: MoE, j: int, E_loc: int, fsdp_n: int, dev, rec: bool
                    ) -> List[torch.Tensor]:
    """Model shard ``j``'s ``wg``, ``wu``, ``wd`` on ``dev``, gathered over
    the ``fsdp_n`` data slices when the weights are FSDP-split."""
    out = []
    for w in (p.wg, p.wu, p.wd):
        w = w[j * E_loc:(j + 1) * E_loc].to(dev)
        if fsdp_n > 1:
            w = _GatherOverData.apply(w, fsdp_n, rec)
        out.append(w)
    return out


def _local(token_slots: torch.Tensor, lo: int, n_s: int) -> torch.Tensor:
    """Each token's slots as indices into model shard rows ``lo .. lo +
    n_s``; a slot outside them (or dropped) becomes ``n_s``, the shard's
    empty slot.  The order within a token stays ascending."""
    loc = token_slots - lo
    return torch.where((loc >= 0) & (loc < n_s), loc, torch.full_like(loc, n_s))


def _data_shard(p: MoE, xf: torch.Tensor, cfg, grid_row, C: int, E_loc: int,
                fsdp_n: int, rec: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One data shard's (T_loc, d) output, summed over its model shards in
    ascending order on the row's first device, and its aux loss."""
    E, k = cfg.n_experts, cfg.top_k
    T, d = xf.shape
    home = grid_row[0]
    xf = xf.to(home)
    logits = xf.float() @ p.router.to(home)
    probs, top_p, top_e, token_slots, perm, slot_token, slot_j = route(
        logits, k, C)
    me = probs.mean(0)
    ce = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = cfg.router_aux_coef * E * (me * ce).sum()
    gates = top_p.gather(1, perm)

    n_s = E_loc * C
    y: Optional[torch.Tensor] = None
    for j, dev in enumerate(grid_row):
        lo = j * n_s
        ts = _local(token_slots, lo, n_s).to(dev)
        st, sj = slot_token[lo:lo + n_s].to(dev), slot_j[lo:lo + n_s].to(dev)
        wg, wu, wd = _expert_weights(p, j, E_loc, fsdp_n, dev, rec and j == 0)
        xe = _Dispatch.apply(xf.to(dev), st, ts).reshape(E_loc, C, d)
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
        ye = torch.bmm(h, wd).reshape(n_s, d)
        part = _Combine.apply(ye, gates.to(dev), ts, st, sj).to(home)
        y = part if y is None else y + part
    return y, aux


def moe_ffn_sharded(p: MoE, x: torch.Tensor, cfg
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe.moe_ffn`` on the mesh ``set_moe_mesh`` installed: x (B, S, d)
    -> (y on x's device, aux loss)."""
    mesh, da = _MOE_MESH
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    tp = mesh.shape["model"]
    if E % tp:
        raise ValueError(f"{E} experts do not divide over {tp} model shards")
    E_loc = E // tp
    grid = shard_grid(mesh, da)
    n_data = grid.shape[0]
    fsdp_n = mesh.shape.get("data", 1) if cfg.fsdp else 1
    if p.wg.shape[1] % fsdp_n:
        raise ValueError(f"d_model {p.wg.shape[1]} does not divide over "
                         f"{fsdp_n} data shards (FSDP)")

    split = B % n_data == 0
    Bl = B // n_data if split else B
    C = _capacity(Bl * S, k, E, cfg.capacity_factor)

    ys, auxes = [], []
    for i in range(n_data):
        xb = x[i * Bl:(i + 1) * Bl] if split else x
        y, aux = _data_shard(p, xb.reshape(Bl * S, d), cfg, list(grid[i]), C,
                             E_loc, fsdp_n, rec=i == 0)
        ys.append(y.to(x.device).reshape(Bl, S, d))
        auxes.append(aux.to(x.device))
    # the psum of the output over 'model', and the two means of aux
    collectives.record("all-reduce", collectives.tensor_bytes(ys[0]))
    collectives.record("all-reduce", collectives.tensor_bytes(auxes[0]))
    if da:
        collectives.record("all-reduce", collectives.tensor_bytes(auxes[0]))
    # a replicated batch: every data shard computed the same block
    out = torch.cat(ys) if split else ys[0]
    aux = torch.stack(auxes).mean()
    if hasattr(p, "shared"):
        out = out + mlp(p.shared, x.reshape(B * S, d), cfg.act).reshape(
            B, S, d)
    return out, aux
