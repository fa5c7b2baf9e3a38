"""Device-resident graph build and repair — port of
``repro.core.device_build``.

CAGRA-style NN-descent: instead of the host's O(n²) ``brute_knn`` or
bucketed ``clustered_knn``, fixed-width per-node candidate lists grow by
sample-and-merge rounds.  Every round proposes neighbours-of-neighbours plus
reverse neighbours (and, unlike the reference, the rest of NN-descent's
local join), scores them in row blocks (a gather and a batched
product, ``qn + pn − 2·dot``), and merges them into the lists through
``kernels.build_kernel.fused_candidate_merge``: the CUDA kernel for tensors
on the card, its plain version (``kernels/ref.candidate_merge_ref``) for CPU
tensors.  The reference routes through its Pallas merge only when asked
(``use_pallas=True``); here the route follows the device.

Also here, as in the reference:

* ``occlusion_prune_device`` — the bulk build prune, a row-blocked mirror of
  ``graph_build.occlusion_prune`` (same scan order, predicate and
  keep-pruned backfill) that turns NN-descent lists into a degree-R graph;
* ``prune_batch`` / ``patch_reverse_edges_batched`` — batched forms of
  ``graph_build.prune_one`` / ``patch_reverse_edges`` for insert repair.

Everything runs on an explicit device (``device=None`` means the card; no
fallback).  Products are full fp32 (``devices.fp32_products``).  Integer
outputs match the reference whenever no occlusion or merge comparison
lands within float rounding of a tie.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.csr import Graph
from repro_torch.core.devices import fp32_products, resolve_device
from repro_torch.core.graph_build import (add_reverse_edges, connect_components,
                                          medoid)
from repro_torch.kernels.build_kernel import fused_candidate_merge
from repro_torch.kernels.ref import BIG

ROUNDS = 8                  # NN-descent rounds after the seeding merge
CPU_SCORE_BLOCK = 1024      # the reference's row blocks, used on the CPU
CPU_PRUNE_BLOCK = 4096


def _rows_per_block(dev: torch.device, row_bytes: int, n: int, cpu_block: int,
                    share: float) -> int:
    """Rows per block: on the card, the rows whose temporaries fit ``share``
    of the free memory (the allocator's cached blocks are returned first,
    so that the free memory is whole, not fragments of the cache); on the
    CPU the reference's fixed block."""
    if dev.type != "cuda":
        return max(8, min(cpu_block, n))
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    return max(8, min(n, int(share * free) // row_bytes))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# NN-descent (CAGRA-style sample-and-merge rounds)
# ---------------------------------------------------------------------------

def _reverse_lists(nbr: torch.Tensor, n: int, S: int) -> torch.Tensor:
    """Fixed-width reverse-neighbour lists: for every forward edge
    i -> nbr[i, s] (< n), node nbr[i, s] receives i as a reverse candidate;
    each node keeps up to S of them, in source order (a stable sort by
    destination and a searchsorted slice).  Returns (n, S) int32 with
    sentinel n."""
    dev = nbr.device
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(
        nbr.shape[1])
    dst_s, order = torch.sort(nbr.reshape(-1), stable=True)  # sentinels last
    src_s = src[order]
    node = torch.arange(n, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(dst_s, node)
    idx = starts[:, None] + torch.arange(S, device=dev)[None, :]
    idxc = idx.clamp(max=dst_s.shape[0] - 1)
    hit = (idx < dst_s.shape[0]) & (dst_s[idxc] == node[:, None])
    return torch.where(hit, src_s[idxc], n)


def _score(x_pad: torch.Tensor, xsq_pad: torch.Tensor, props: torch.Tensor,
           n: int, block: Optional[int]) -> torch.Tensor:
    """(n, P) squared distances of row i to its proposals ``props[i]``,
    ``max(qn + pn − 2·dot, 0)``, BIG where the proposal is >= n; computed
    in row blocks so the (block, P, d) gather stays bounded (``block``
    None: the reference's 1024 rows on the CPU; on the card what a quarter
    of the free memory holds, sized once the proposals are allocated)."""
    out = torch.empty(props.shape, dtype=torch.float32, device=props.device)
    if block is None:
        # (P, d) gathered rows plus about four (P,) temporaries per row
        block = _rows_per_block(props.device, 4 * props.shape[1]
                                * (x_pad.shape[1] + 4), n, CPU_SCORE_BLOCK,
                                0.25)
    block = max(8, min(block, n))
    for s in range(0, n, block):
        e = min(s + block, n)
        pr = props[s:e].long().clamp(max=n)
        pv = x_pad[pr]                                        # (b, P, d)
        dot = torch.bmm(pv, x_pad[s:e, :, None])[..., 0]
        d = xsq_pad[s:e, None] + xsq_pad[pr] - 2.0 * dot
        out[s:e] = torch.where(pr >= n, BIG, torch.clamp_min(d, 0.0))
    return out


def _proposals(ids: torch.Tensor, n: int, S: int, local: bool) -> torch.Tensor:
    """A round's proposals, from the first S entries N(i) of each list and
    up to S reverse neighbours R(i):

    * ``local`` False (the reference's): N(N(i)), then R(i), S² + S;
    * ``local`` True (NN-descent's local join, in which every two members of
      N(v) ∪ R(v) meet): N(N(i)), N(R(i)), R(N(i)), then R(i), 3·S² + S.

    Self is masked to n."""
    nbr = ids[:, :S]
    rev = _reverse_lists(nbr, n, S)
    pad = nbr.new_full((1, S), n)
    nbr_tbl = torch.cat([nbr, pad])
    parts = [nbr_tbl[nbr.long().clamp(max=n)]]
    if local:
        rev_tbl = torch.cat([rev, pad])
        parts += [nbr_tbl[rev.long().clamp(max=n)],
                  rev_tbl[nbr.long().clamp(max=n)]]
    props = torch.cat([p.reshape(n, S * S) for p in parts] + [rev], dim=1)
    self_id = torch.arange(n, dtype=props.dtype, device=props.device)[:, None]
    return torch.where(props == self_id, n, props)


def _nn_descent_round(x_pad: torch.Tensor, xsq_pad: torch.Tensor,
                      ids: torch.Tensor, dd: torch.Tensor, *, n: int, S: int,
                      block: Optional[int], local: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sample-and-merge round over (n, K) candidate lists: the
    proposals of ``_proposals``, scored, then merged.  Monotone: the merged
    multiset holds every incumbent, so per-rank distances never increase
    round over round."""
    props = _proposals(ids, n, S, local)
    return fused_candidate_merge(ids, dd, props,
                                 _score(x_pad, xsq_pad, props, n, block), n)


def _nn_descent(x_pad: torch.Tensor, K: int, *, rounds: int, S: int,
                seed: int, block: Optional[int], local: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NN-descent on the device of ``x_pad`` ((n+1, d), zero last row),
    with the local join unless ``local`` is False (the reference's
    proposals, see ``build_graph_device``).  Returns (ids (n, K) int32 sentinel n, d2 (n, K) fp32, BIG on
    sentinels) on that device."""
    n = x_pad.shape[0] - 1
    dev = x_pad.device
    rng = np.random.default_rng(seed)
    xsq_pad = (x_pad * x_pad).sum(-1)
    ids = torch.full((n, K), n, dtype=torch.int32, device=dev)
    dd = torch.full((n, K), BIG, dtype=torch.float32, device=dev)

    # seeding round: random proposals through the same merge (dedupes
    # collisions, masks self); the reference's generator, scored blocked
    # on the device instead of an (n, K, d) host array
    props0 = rng.integers(0, n, size=(n, K)).astype(np.int32)
    props0 = np.where(props0 == np.arange(n)[:, None], n, props0)
    props0 = torch.from_numpy(props0.astype(np.int32)).to(dev)
    d0 = _score(x_pad, xsq_pad, props0, n, block)
    ids, dd = fused_candidate_merge(ids, dd, props0, d0, n)
    del props0, d0

    for _ in range(max(0, rounds)):
        ids, dd = _nn_descent_round(x_pad, xsq_pad, ids, dd, n=n, S=S,
                                    block=block, local=local)
    return ids, dd


def _pad_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def nn_descent(x: np.ndarray, K: int, *, rounds: int = ROUNDS,
               S: Optional[int] = None, seed: int = 0,
               block: Optional[int] = None, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Approximate K-NN lists for every row of ``x``, built on ``device``
    with the local-join proposals (``_proposals``).

    Returns host (ids (n, K) int32 sentinel ``n``, d2 (n, K) float32 with
    +inf on sentinels) — drop-in for ``brute_knn``/``clustered_knn``.  Work
    per round is O(n·P·d) with P = 3·S² + S proposals per node, against
    brute force's O(n²·d) in all.  ``block``: rows scored at once (default:
    the reference's 1024 on the CPU, what a quarter of the free memory
    holds on the card)."""
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, np.float32)
    n = x.shape[0]
    K = min(K, max(1, n - 1))
    S = S if S is not None else min(K, 16)
    with torch.no_grad(), fp32_products():
        x_pad = _pad_rows(torch.from_numpy(x).to(dev))
        ids, dd = _nn_descent(x_pad, K, rounds=rounds, S=S, seed=seed,
                              block=block)
        dd = torch.where(ids >= n, float("inf"), dd)
        return ids.cpu().numpy(), dd.cpu().numpy()


# ---------------------------------------------------------------------------
# Bulk occlusion prune (build time; mirrors graph_build.occlusion_prune)
# ---------------------------------------------------------------------------

def _occlusion_prune_block(x: torch.Tensor, cand_ids: torch.Tensor,
                           cand_d: torch.Tensor, n: int, alpha: float, *,
                           R: int, keep_pruned: bool) -> torch.Tensor:
    """One row block: the host version's column scan, predicate and
    backfill, vectorised over the block with a kept-vector carry.  Slot R
    of the carries is a dump slot that absorbs rows that take nothing."""
    B, K = cand_ids.shape
    dev = x.device
    rows = torch.arange(B, device=dev)
    iota_r = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    a = torch.tensor(alpha, dtype=torch.float32, device=dev)
    a2 = a * a                                  # fp32, as the reference's
    kept = torch.full((B, R + 1), n, dtype=torch.int32, device=dev)
    kept_vecs = torch.zeros((B, R + 1, x.shape[1]), dtype=torch.float32,
                            device=dev)
    cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    taken = torch.zeros((B, K), dtype=torch.bool, device=dev)
    live = (cand_ids < n) & torch.isfinite(cand_d)
    for j in range(K):
        c = cand_ids[:, j]
        cv = x[c.long().clamp(0, x.shape[0] - 1)]
        diff = kept_vecs[:, :R] - cv[:, None, :]
        d_kc = diff.mul_(diff).sum(-1)                        # (B, R)
        occluded = ((iota_r < cnt[:, None])
                    & (d_kc < cand_d[:, j, None] / a2)).any(1)
        take = live[:, j] & (cnt < R) & ~occluded
        slot = torch.where(take, cnt, R).long()
        kept[rows, slot] = c
        kept_vecs[rows, slot] = cv
        cnt += take.to(torch.int32)
        taken[:, j] = take
    if keep_pruned:
        for j in range(K):
            fill = ~taken[:, j] & live[:, j] & (cnt < R)
            kept[rows, torch.where(fill, cnt, R).long()] = cand_ids[:, j]
            cnt += fill.to(torch.int32)
    return kept[:, :R]


def _occlusion_prune(x: torch.Tensor, cand_ids: torch.Tensor,
                     cand_d: torch.Tensor, R: int, *, alpha: float,
                     keep_pruned: bool, block: Optional[int]) -> torch.Tensor:
    """Row-blocked prune on the device of ``x``; returns (n, R) int32."""
    n, K = cand_ids.shape
    dev = x.device
    if block is None:
        # kept vectors (R+1, d) + the (R, d) difference + small per row
        block = _rows_per_block(dev, 4 * ((2 * R + 1) * x.shape[1] + 4 * K),
                                n, CPU_PRUNE_BLOCK, 0.5)
    block = max(8, min(block, n))
    out = torch.empty((n, R), dtype=torch.int32, device=dev)
    for s in range(0, n, block):
        e = min(s + block, n)
        out[s:e] = _occlusion_prune_block(
            x, cand_ids[s:e].to(torch.int32), cand_d[s:e].float(), n, alpha,
            R=R, keep_pruned=keep_pruned)
    return out


def occlusion_prune_device(x: np.ndarray, cand_ids: np.ndarray,
                           cand_d: np.ndarray, R: int, *, alpha: float = 1.2,
                           keep_pruned: bool = True,
                           block: Optional[int] = None,
                           device=None) -> np.ndarray:
    """Device mirror of ``graph_build.occlusion_prune`` (same scan order,
    predicate and backfill).  ``block``: rows at once (default: the
    reference's 4096 on the CPU, what half the free memory holds on the
    card).  Returns host (n, R) int32 with sentinel n."""
    dev = resolve_device(device)
    with torch.no_grad():
        out = _occlusion_prune(
            torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev),
            torch.from_numpy(np.asarray(cand_ids, np.int32)).to(dev),
            torch.from_numpy(np.asarray(cand_d, np.float32)).to(dev), R,
            alpha=alpha, keep_pruned=keep_pruned, block=block)
        return out.cpu().numpy()


def _reverse_prune(x_pad: torch.Tensor, nb: torch.Tensor, R: int, *,
                   alpha: float) -> torch.Tensor:
    """The reverse-edge pass of NSG/Vamana on the device: each node's
    candidates become its R kept neighbours plus up to R of the nodes that
    kept it (``_reverse_lists``), deduplicated and sorted by the candidate
    merge, then occlusion-pruned back to R.  A node that no list kept can
    so win an in-edge from the nodes it points to.  (The reference adds
    reverse edges only into free slots, and after a keep-pruned prune there
    are none.)"""
    n = nb.shape[0]
    xsq_pad = (x_pad * x_pad).sum(-1)
    cand = torch.cat([nb, _reverse_lists(nb, n, R)], dim=1)       # (n, 2R)
    cand_d = _score(x_pad, xsq_pad, cand, n, None)
    ids, dd = fused_candidate_merge(torch.full_like(cand, n),
                                    torch.full_like(cand_d, BIG), cand,
                                    cand_d, n)
    return _occlusion_prune(x_pad, ids, dd, R, alpha=alpha, keep_pruned=True,
                            block=None)


# ---------------------------------------------------------------------------
# Batched repair prune (insert time; mirrors graph_build.prune_one)
# ---------------------------------------------------------------------------

def _prune_batch(cand_vecs: torch.Tensor, cand_d: torch.Tensor,
                 edge_ok: torch.Tensor, alpha: float, *, R: int,
                 keep_pruned: bool) -> torch.Tensor:
    B, C, dim = cand_vecs.shape
    dev = cand_vecs.device
    sd, order = torch.sort(cand_d, dim=1, stable=True)
    sv = cand_vecs.gather(1, order[:, :, None].expand(B, C, dim))
    sok = edge_ok.gather(1, order)
    sfin = torch.isfinite(sd)
    a = torch.tensor(alpha, dtype=torch.float32, device=dev)
    a2 = a * a
    taken = torch.zeros((B, C), dtype=torch.bool, device=dev)
    etaken = torch.zeros((B, C), dtype=torch.bool, device=dev)
    ecnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    for t in range(C):
        diff = sv - sv[:, t, None, :]
        d_kc = diff.mul_(diff).sum(-1)                        # (B, C)
        occ = (taken & (d_kc < sd[:, t, None] / a2)).any(1)
        take = sfin[:, t] & (ecnt < R) & ~occ
        taken[:, t] = take
        etaken[:, t] = take & sok[:, t]
        ecnt += etaken[:, t].to(torch.int32)

    take_fill = torch.zeros_like(taken)
    if keep_pruned:
        fill = ~taken & sok & sfin
        rank = fill.to(torch.int32).cumsum(1) - fill.to(torch.int32)
        take_fill = fill & (rank < (R - ecnt)[:, None])

    # host append order: main-loop edges in scan order, then backfill
    iota_c = torch.arange(C, device=dev)[None, :]
    key = torch.where(etaken, iota_c, torch.where(take_fill, C + iota_c, 2 * C))
    skey, sel = torch.sort(key, dim=1, stable=True)
    orig = order.gather(1, sel[:, :R])
    return torch.where(skey[:, :R] < 2 * C, orig, -1).to(torch.int32)


def prune_batch(cand_vecs: np.ndarray, cand_d: np.ndarray, R: int, *,
                alpha: float = 1.2, edge_ok: Optional[np.ndarray] = None,
                keep_pruned: bool = True, device=None) -> np.ndarray:
    """Batched ``graph_build.prune_one``: prune B candidate lists in one
    call on ``device``.  ``cand_vecs`` (B, C, d), ``cand_d`` (B, C) with
    +inf marking padded/invalid slots, ``edge_ok`` (B, C) — False rows join
    the kept set as occluders but never take an edge slot.

    Returns (B, R) int32 indices into the candidate axis in the host
    primitive's append order (scan-order keepers, then keep-pruned
    backfill), padded with -1."""
    dev = resolve_device(device)
    cand_vecs = np.ascontiguousarray(cand_vecs, np.float32)
    B, C, _ = cand_vecs.shape
    ok = (np.ones((B, C), bool) if edge_ok is None
          else np.ascontiguousarray(edge_ok, bool))
    with torch.no_grad():
        out = _prune_batch(
            torch.from_numpy(cand_vecs).to(dev),
            torch.from_numpy(np.ascontiguousarray(cand_d, np.float32)).to(dev),
            torch.from_numpy(ok).to(dev), alpha, R=R, keep_pruned=keep_pruned)
        return out.cpu().numpy()


def warm_prune_batch(shapes, R: int, *, keep_pruned: bool = True,
                     device=None) -> None:
    """Run ``prune_batch`` once on zeros for each (B, C, d) signature, so an
    insert's first repair does not pay the device's first-call set-up
    (allocator pools, library handles) inside a serving window."""
    for (B, C, d) in shapes:
        prune_batch(np.zeros((B, C, d), np.float32),
                    np.full((B, C), np.inf, np.float32), R,
                    keep_pruned=keep_pruned, device=device)


def patch_reverse_edges_batched(neighbors: np.ndarray, x: np.ndarray,
                                src_ids: np.ndarray, n: int, R: int, *,
                                alpha: float = 1.2,
                                device=None) -> np.ndarray:
    """Batched ``graph_build.patch_reverse_edges`` (in place): reverse edges
    for a whole insert batch are collected per target row first (arrival
    order, deduplicated against the row and the queue), free slots are
    appended in bulk, and every *overflowing* row is re-pruned in ONE
    ``prune_batch`` call.

    For a single inserted node this is step-for-step the host primitive.
    For a batch it differs only when two or more new nodes overflow the
    same target row: the host re-prunes that row once per arrival, this
    path once over the whole incoming set.  (The reference pads the batch
    to shape rungs for its jit cache; eager PyTorch needs no padding, and
    padding does not change the kept rows.)"""
    nbr_w = neighbors.shape[1]
    incoming: dict = {}
    for u in np.asarray(src_ids, np.int64):
        for v in neighbors[u]:
            v = int(v)
            if v >= n or v == u:
                continue
            row = neighbors[v]
            deg = int((row < n).sum())
            if (row[:deg] == u).any():
                continue
            q = incoming.setdefault(v, [])
            if u not in q:
                q.append(int(u))
    full = []
    for v, us in incoming.items():
        deg = int((neighbors[v] < n).sum())
        if deg + len(us) <= R:
            neighbors[v, deg:deg + len(us)] = np.asarray(us, neighbors.dtype)
        else:
            full.append((v, us, deg))
    if not full:
        return neighbors
    C = max(deg + len(us) for _, us, deg in full)
    cand = np.full((len(full), C), -1, np.int64)
    cd = np.full((len(full), C), np.inf, np.float32)
    cv = np.zeros((len(full), C, x.shape[1]), np.float32)
    for i, (v, us, deg) in enumerate(full):
        c = np.concatenate([neighbors[v][:deg], us]).astype(np.int64)
        diff = x[c] - x[v][None, :]
        cand[i, :len(c)] = c
        cd[i, :len(c)] = (diff * diff).sum(-1).astype(np.float32)
        cv[i, :len(c)] = x[c]
    kept = prune_batch(cv, cd, R, alpha=alpha, device=device)
    for i, (v, us, deg) in enumerate(full):
        sel = kept[i][kept[i] >= 0]
        new_row = np.full(nbr_w, n, neighbors.dtype)
        new_row[:len(sel)] = cand[i, sel]
        neighbors[v] = new_row
    return neighbors


# ---------------------------------------------------------------------------
# Full device build
# ---------------------------------------------------------------------------

def build_graph_device(x: np.ndarray, R: int = 32, *, alpha: float = 1.2,
                       knn_k: Optional[int] = None, seed: int = 0,
                       rounds: int = ROUNDS, reverse: bool = True,
                       repair: bool = True, device=None,
                       timings: Optional[Dict[str, float]] = None,
                       _reference: bool = False) -> Graph:
    """``graph_build.build_graph`` with the host kNN replaced by NN-descent
    and the prune run on ``device``; reverse-edge augmentation and the
    NSG-style connectivity repair stay host numpy, as in the reference.
    ``timings``, when given, receives the wall seconds of ``knn``
    (NN-descent), ``prune`` and ``reverse_repair``.

    The build adds two steps to the reference's, because the reference's
    build misses its own bar (search recall@10 within 0.01 of the exact
    build) on DEEP-shaped data (PERF.md, PR 12): the local-join proposals,
    whose lists are closer to exact, and ``_reverse_prune`` after the
    prune, without which 4% of the nodes of a 1M graph have no in-edge.
    Each step alone missed one of ``chip_smoke.py``'s bars on the card.
    ``_reference=True`` leaves both out: the reference's build, array for
    array, for the parity tests."""
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, np.float32)
    n = x.shape[0]
    knn_k = min(knn_k or min(n - 1, 2 * R), max(1, n - 1))
    t = {}
    t0 = time.perf_counter()
    with torch.no_grad(), fp32_products():
        x_pad = _pad_rows(torch.from_numpy(x).to(dev))
        ids, dd = _nn_descent(x_pad, knn_k, rounds=rounds,
                              S=min(knn_k, 16), seed=seed, block=None,
                              local=not _reference)
        dd = torch.where(ids >= n, float("inf"), dd)
        _sync(dev)
        t["knn"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        nb = _occlusion_prune(x_pad, ids, dd, R, alpha=alpha,
                              keep_pruned=True, block=None)
        del ids, dd
        if not _reference:
            nb = _reverse_prune(x_pad, nb, R, alpha=alpha)
        nb = nb.cpu().numpy()
        del x_pad
    t["prune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if reverse:
        nb = add_reverse_edges(nb, n, R)
    if repair and n > 1:
        nb = connect_components(nb, x, medoid(x))
    t["reverse_repair"] = time.perf_counter() - t0
    if timings is not None:
        timings.update(t)
    return Graph(nb.astype(np.int32), n)
