"""Fast Entry Selection (PilotANN §5) — port of ``repro.core.fes``.

Entry vectors are organised into a small number r of coarse clusters
(r = 32 in the paper, matching the GPU warp width).  Queries are routed to
their nearest centroid and distances are computed only against that
cluster's entries, with GEMM-like density  mn / (r(m+n))  (Table 2).

The build side is a numpy copy of the reference (same seed, same arrays);
``fes_select_ref`` is the plain PyTorch selection that the CPU path runs.
The card's path is ``kernels/ops.fes_select`` around the CUDA distance
kernel; both give the same ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.graph_build import kmeans, pairwise_sq_dists

INF = float("inf")


@dataclass
class FESIndex:
    centroids: np.ndarray   # (r, d)
    entries: np.ndarray     # (r, C, d)  cluster-bucketed entry vectors (padded)
    entry_ids: np.ndarray   # (r, C)     original node ids (sentinel = n)
    valid: np.ndarray       # (r, C)     padding mask
    n: int

    @property
    def r(self) -> int:
        return self.centroids.shape[0]

    @property
    def capacity(self) -> int:
        return self.entries.shape[1]


def fes_capacity_cap(n_entry: int, r: int, align: int = 128) -> int:
    """Upper bound on the padded per-cluster capacity: 2× the mean bucket
    size, align-rounded (``build_fes`` enforces it)."""
    return max(align, -(-max(1, (2 * n_entry) // r) // align) * align)


def build_fes(vectors: np.ndarray, candidate_ids: np.ndarray, *, r: int = 32,
              n_entry: int = 8192, seed: int = 0, align: int = 128,
              max_capacity: int = None) -> FESIndex:
    """Sample ``n_entry`` entry vectors from candidate_ids, cluster into r
    coarse buckets, pad buckets to a common 128-aligned capacity (bounded
    by ``max_capacity`` when given; entries past it in an over-full bucket
    are dropped)."""
    rng = np.random.default_rng(seed)
    n = vectors.shape[0]
    n_entry = min(n_entry, len(candidate_ids))
    ids = rng.choice(candidate_ids, size=n_entry, replace=False)
    ev = vectors[ids].astype(np.float32)
    cent = kmeans(ev, r, seed=seed)
    assign = np.argmin(pairwise_sq_dists(ev, cent), axis=1)
    counts = np.bincount(assign, minlength=r)
    C = int(max(1, -(-counts.max() // align) * align))
    if max_capacity is not None:
        C = min(C, max(align, max_capacity))
    buckets = np.zeros((r, C, vectors.shape[1]), np.float32)
    bucket_ids = np.full((r, C), n, np.int32)
    valid = np.zeros((r, C), bool)
    for c in range(r):
        members = np.flatnonzero(assign == c)[:C]
        buckets[c, :len(members)] = ev[members]
        bucket_ids[c, :len(members)] = ids[members]
        valid[c, :len(members)] = True
    return FESIndex(centroids=cent, entries=buckets, entry_ids=bucket_ids,
                    valid=valid, n=n)


def mask_tombstoned(valid: torch.Tensor, entry_ids: torch.Tensor,
                    tombstone: torch.Tensor) -> torch.Tensor:
    """Drop tombstoned entries from an FES validity mask: ``tombstone`` is
    the (n+1,) deletion bitmap in ``entry_ids``' id space.  Shared by the
    plain selection and ``kernels/ops.fes_select``."""
    t = tombstone[entry_ids.long().clamp(0, tombstone.shape[0] - 1)]
    return valid & ~t


def topk_smallest(d: torch.Tensor, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The L smallest of each row, ties toward the lower index (what
    ``lax.top_k(-d, L)`` gives; ``torch.topk`` promises no tie order)."""
    sd, idx = torch.sort(d, dim=1, stable=True)
    return sd[:, :L], idx[:, :L]


def fes_select_ref(queries: torch.Tensor, centroids: torch.Tensor,
                   entries: torch.Tensor, entry_ids: torch.Tensor,
                   valid: torch.Tensor, L: int,
                   entries_scale: torch.Tensor = None,
                   entries_codebook: torch.Tensor = None,
                   tombstone: torch.Tensor = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route each query to its nearest centroid, score only that cluster's
    entries, return top-L (ids, sq-dists).

    queries (B, d); centroids (r, d) fp32; entries (r, C, ·) stored fp32,
    bf16, int8 or int4 (``entries_scale`` (d,) for int8/int4) or pq codes
    (``entries_codebook``); -> (B, L) ids/dists.  ``tombstone``: optional
    deletion bitmap in the entry-id space."""
    if tombstone is not None:
        valid = mask_tombstoned(valid, entry_ids, tombstone)
    q = queries.float()
    route = torch.argmin(_xdist(q, centroids), dim=1)      # (B,)
    ev = quant.decode_rows(entries[route], entries_scale,   # (B, C, d)
                           codebook=entries_codebook).float()
    d = _rowdist(q, ev).masked_fill(~valid[route], INF)    # (B, C)
    sd, idx = topk_smallest(d, L)
    return entry_ids[route].gather(1, idx), sd


def fes_select_bruteforce(queries: torch.Tensor, entries: torch.Tensor,
                          entry_ids: torch.Tensor, valid: torch.Tensor, L: int,
                          entries_scale: torch.Tensor = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-block case of Table 2: score ALL entries (no routing) and
    return the top-L (ids, sq-dists).  ``entries`` (r, C, d) stored fp32,
    bf16 or int8 (``entries_scale`` (d,) for int8)."""
    r, C, d_ = entries.shape
    ev = entries.reshape(r * C, d_).float()
    if entries_scale is not None:
        ev = ev * entries_scale.float()
    d = _xdist(queries.float(), ev).masked_fill(~valid.reshape(1, -1), INF)
    sd, idx = topk_smallest(d, L)
    return entry_ids.reshape(-1)[idx], sd


def _xdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = (a * a).sum(-1)[:, None]
    bn = (b * b).sum(-1)[None, :]
    return torch.clamp_min(an + bn - 2.0 * (a @ b.T), 0.0)


def _rowdist(q: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    qn = (q * q).sum(-1)[:, None]
    en = (ev * ev).sum(-1)
    dot = torch.einsum("bd,bcd->bc", q, ev)
    return torch.clamp_min(qn + en - 2.0 * dot, 0.0)
