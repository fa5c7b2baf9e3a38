"""Wrappers around the port's kernels.

``fes_select`` is the card's FES path: route → group queries by cluster
(one stable sort) → distance kernel (``fes_kernel.fes_distances``: K3, or
K4/K5 for int4/pq entries) → mask → top-L → scatter back to query order.
Same ids as ``core.fes.fes_select_ref``.  Port of
``repro.kernels.ops.fes_select``, without the TPU's 128-lane padding of C
and d (the CUDA kernels mask their ragged edges).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.fes import mask_tombstoned, topk_smallest
from repro_torch.kernels.fes_kernel import fes_distances

INF = float("inf")


def group_queries(queries: torch.Tensor, centroids: torch.Tensor, qc: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route each query to its nearest centroid and lay the batch out as
    (r, qc, d) per-cluster groups (zero rows pad each group; queries past a
    group's capacity ``qc`` are dropped).  Returns ``(q_grouped,
    q_at_slot)`` with ``q_at_slot`` (r·qc,) the query index of every slot
    (B for an empty slot).  The routing product stays ``torch.matmul``, as
    it stayed outside the kernel in the reference."""
    B, d = queries.shape
    r = centroids.shape[0]
    q = queries.float()
    dev = q.device
    qn = (q * q).sum(-1)[:, None]
    cn = (centroids * centroids).sum(-1)[None, :]
    route = torch.argmin(qn + cn - 2.0 * (q @ centroids.T), dim=1)   # (B,)

    order = torch.sort(route, stable=True).indices                   # (B,)
    sroute = route[order]
    # each cluster's first position in the sorted routes (``bincount``
    # would read the routes' maximum back to the host: no host sync here,
    # so that a CUDA graph can capture the selection)
    starts = torch.searchsorted(sroute, torch.arange(r, device=dev))
    rank = torch.arange(B, device=dev) - starts[sroute]
    ok = rank < qc                                                   # capacity
    slot = torch.where(ok, sroute * qc + rank, r * qc)
    q_at_slot = torch.full((r * qc + 1,), B, dtype=torch.int64, device=dev)
    q_at_slot[slot] = torch.where(ok, order, B)
    q_at_slot = q_at_slot[: r * qc]
    qpad = torch.cat([q, q.new_zeros((1, d))], dim=0)
    return qpad[q_at_slot].reshape(r, qc, d), q_at_slot


def fes_select(queries: torch.Tensor, centroids: torch.Tensor,
               entries: torch.Tensor, entry_ids: torch.Tensor,
               valid: torch.Tensor, *, L: int, qc: Optional[int] = None,
               entries_scale: Optional[torch.Tensor] = None,
               entries_codebook: Optional[torch.Tensor] = None,
               tombstone: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (B, d); centroids (r, d) fp32 (routing stays fp32); entries
    (r, C, ·) in any pilot encoding, at their stored (packed) width:
    fp32/bf16/int8 with an optional ``entries_scale`` (d,), int4 with
    ``entries_scale`` (d,), pq codes with ``entries_codebook``.  Returns
    (ids (B, L), sq-dists (B, L)) — top-L entries of each query's routed
    cluster, ties toward the lower entry index.  ``qc``: per-cluster query
    capacity (defaults to B — always safe).  ``tombstone``: optional
    deletion bitmap in the entry-id space."""
    if tombstone is not None:
        valid = mask_tombstoned(valid, entry_ids, tombstone)
    B = queries.shape[0]
    r, C, _ = entries.shape
    qc = qc or B
    q_grouped, q_at_slot = group_queries(queries, centroids, qc)
    dist = fes_distances(q_grouped, entries, scale=entries_scale,
                         codebook=entries_codebook)                 # (r, qc, C)
    dist = dist.masked_fill(~valid[:, None, :], INF).reshape(r * qc, C)
    sd, idx = topk_smallest(dist, L)
    rows = torch.arange(r * qc, device=dist.device) // qc
    sel_ids = entry_ids[rows].gather(1, idx).to(torch.int32)

    dev = dist.device
    out_ids = torch.zeros((B + 1, L), dtype=torch.int32, device=dev)
    out_d = torch.full((B + 1, L), INF, dtype=torch.float32, device=dev)
    out_ids[q_at_slot] = sel_ids        # empty slots all land on row B
    out_d[q_at_slot] = sd
    return out_ids[:B], out_d[:B]
