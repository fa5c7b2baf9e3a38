"""Graph construction substrate — numpy copy of ``repro.core.graph_build``
(the port imports nothing of the JAX package): exact / clustered approximate
kNN graphs with HNSW-style occlusion pruning and reverse-edge augmentation.

PilotANN is construction-agnostic (it reuses the index's own build algorithm;
§A.2 shows orthogonality to HNSW vs NSG).  The vectorised NSW-family construction:
  1. kNN candidates (exact blockwise, or kmeans-bucketed approximate),
  2. occlusion pruning (the HNSW/NSG "heuristic"): keep neighbour c only if
     d(q, c) < alpha * min_{kept k} d(k, c),
  3. reverse edges + degree cap.

The same seed gives the same graph as the reference, array for array.
``method="nn_descent"`` is the device build (``core/device_build``), which
runs on the ``device`` it is given.  The insert-repair primitives
(``prune_one``, ``greedy_candidates``, ``patch_reverse_edges``) are the
host versions the batched device repair is held against.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.csr import Graph


def pairwise_sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m, d) x (n, d) -> (m, n) squared euclidean."""
    a2 = (a * a).sum(-1)[:, None]
    b2 = (b * b).sum(-1)[None, :]
    return np.maximum(a2 + b2 - 2.0 * (a @ b.T), 0.0)


def brute_knn(x: np.ndarray, k: int, *, block: int = 4096,
              queries: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN (excluding self when queries is None).  Returns (ids, d2)."""
    q = x if queries is None else queries
    m, n = q.shape[0], x.shape[0]
    ids = np.empty((m, k), np.int32)
    dd = np.empty((m, k), np.float32)
    x2 = (x * x).sum(-1)
    for s in range(0, m, block):
        e = min(s + block, m)
        d2 = x2[None, :] - 2.0 * (q[s:e] @ x.T)
        d2 += (q[s:e] * q[s:e]).sum(-1)[:, None]
        if queries is None:
            d2[np.arange(e - s), np.arange(s, e)] = np.inf
        part = np.argpartition(d2, k, axis=1)[:, :k]
        pd = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(pd, axis=1)
        ids[s:e] = np.take_along_axis(part, order, axis=1)
        dd[s:e] = np.take_along_axis(pd, order, axis=1)
    return ids, np.maximum(dd, 0.0)


def kmeans(x: np.ndarray, k: int, *, iters: int = 8, seed: int = 0,
           sample: int = 65536) -> np.ndarray:
    """Lloyd's with kmeans-ish init on a sample.  Returns centroids (k, d)."""
    rng = np.random.default_rng(seed)
    xs = x[rng.choice(x.shape[0], size=min(sample, x.shape[0]), replace=False)]
    k = min(k, xs.shape[0])  # degenerate tiny inputs (e.g. cache warm-up)
    cent = xs[rng.choice(xs.shape[0], size=k, replace=False)].astype(np.float32)
    for _ in range(iters):
        a = np.argmin(pairwise_sq_dists(xs, cent), axis=1)
        for c in range(k):
            m = a == c
            if m.any():
                cent[c] = xs[m].mean(axis=0)
            else:
                cent[c] = xs[rng.integers(xs.shape[0])]
    return cent


def clustered_knn(x: np.ndarray, k: int, *, n_clusters: int = 64,
                  n_probe: int = 3, seed: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Approximate kNN: assign points to kmeans buckets, search the n_probe
    nearest buckets of each point.  O(n * n/c * probe) instead of O(n^2)."""
    n = x.shape[0]
    cent = kmeans(x, n_clusters, seed=seed)
    d2c = pairwise_sq_dists(x, cent)
    probes = np.argsort(d2c, axis=1)[:, :n_probe]          # (n, probe)
    assign = probes[:, 0]
    buckets = [np.flatnonzero(assign == c) for c in range(n_clusters)]
    ids = np.full((n, k), n, np.int32)
    dd = np.full((n, k), np.inf, np.float32)
    for c in range(n_clusters):
        members = buckets[c]
        if len(members) == 0:
            continue
        searchers = np.flatnonzero((probes == c).any(axis=1))
        for s in range(0, len(searchers), 2048):
            qs = searchers[s:s + 2048]
            d2 = pairwise_sq_dists(x[qs], x[members])
            self_mask = qs[:, None] == members[None, :]
            d2[self_mask] = np.inf
            kk = min(k, len(members))
            part = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
            pd = np.take_along_axis(d2, part, axis=1)
            cand_ids = members[part]
            # merge with existing
            all_ids = np.concatenate([ids[qs], cand_ids], axis=1)
            all_d = np.concatenate([dd[qs], pd], axis=1)
            order = np.argsort(all_d, axis=1)[:, :k]
            merged_ids = np.take_along_axis(all_ids, order, axis=1)
            merged_d = np.take_along_axis(all_d, order, axis=1)
            # dedupe (same id may enter via two probes)
            dup = merged_ids[:, 1:] == merged_ids[:, :-1]
            merged_d[:, 1:][dup] = np.inf
            order2 = np.argsort(merged_d, axis=1)
            ids[qs] = np.take_along_axis(merged_ids, order2, axis=1)
            dd[qs] = np.take_along_axis(merged_d, order2, axis=1)
    return ids, dd


def occludes(d_kc, d_qc, alpha: float):
    """The occlusion predicate (squared-distance domain): an already-kept
    neighbour k occludes candidate c of node q iff
    ``d(k, c) < d(q, c) / alpha**2``.  Monotone in alpha: occluded at a
    larger alpha implies occluded at any smaller alpha."""
    return d_kc < d_qc / (alpha * alpha)


def occlusion_prune(x: np.ndarray, cand_ids: np.ndarray, cand_d: np.ndarray,
                    R: int, *, alpha: float = 1.2,
                    keep_pruned: bool = True) -> np.ndarray:
    """HNSW 'select_neighbors_heuristic' vectorised over nodes:
    iterate candidates by distance; keep c unless an already-kept k occludes
    it (d(k, c) < d(q, c) / alpha).  With ``keep_pruned`` (HNSW's
    keepPrunedConnections), leftover slots are backfilled with the nearest
    occluded candidates — important for graph connectivity.
    Returns (n, R) with sentinel n."""
    n, K = cand_ids.shape
    kept = np.full((n, R), n, np.int32)
    kept_cnt = np.zeros(n, np.int32)
    kept_vecs = np.zeros((n, R, x.shape[1]), np.float32)
    taken = np.zeros((n, K), bool)
    for j in range(K):
        c = cand_ids[:, j]
        valid = (c < n) & np.isfinite(cand_d[:, j]) & (kept_cnt < R)
        if not valid.any():
            continue
        cv = x[np.clip(c, 0, n - 1)]
        # occlusion test against kept
        diff = kept_vecs - cv[:, None, :]
        d_kc = (diff * diff).sum(-1)                       # (n, R)
        mask_k = np.arange(R)[None, :] < kept_cnt[:, None]
        occluded = (mask_k & occludes(d_kc, cand_d[:, j][:, None], alpha)).any(axis=1)
        take = valid & ~occluded
        rows = np.flatnonzero(take)
        slots = kept_cnt[rows]
        kept[rows, slots] = c[rows]
        kept_vecs[rows, slots] = cv[rows]
        kept_cnt[rows] += 1
        taken[rows, j] = True
    if keep_pruned:
        for j in range(K):
            c = cand_ids[:, j]
            fill = (~taken[:, j]) & (c < n) & np.isfinite(cand_d[:, j]) & (kept_cnt < R)
            rows = np.flatnonzero(fill)
            if len(rows) == 0:
                continue
            kept[rows, kept_cnt[rows]] = c[rows]
            kept_cnt[rows] += 1
    return kept


def prune_one(cand_vecs: np.ndarray, cand_d: np.ndarray, R: int, *,
              alpha: float = 1.2, edge_ok: Optional[np.ndarray] = None,
              keep_pruned: bool = True) -> np.ndarray:
    """Occlusion-prune the candidate list of ONE node (the insert-time
    repair primitive, DESIGN.md §6).  ``cand_vecs`` (K, d) / ``cand_d``
    (K,) are the node's collected candidates; candidates with
    ``edge_ok=False`` (e.g. base-segment nodes a delta node cannot link to)
    still join the kept set as *occluders* but never consume an edge slot.

    Scans candidates in distance order, keeping c unless an already-kept k
    occludes it (``occludes``); with ``keep_pruned``, leftover edge slots
    backfill with the nearest occluded edge-eligible candidates.  Returns
    the kept-edge indices into the candidate arrays (≤ R, distance order).
    """
    K = len(cand_d)
    edge_ok = np.ones(K, bool) if edge_ok is None else edge_ok
    order = np.argsort(cand_d, kind="stable")
    kept_vecs: list = []
    edges: list = []
    taken = np.zeros(K, bool)
    for j in order:
        if not np.isfinite(cand_d[j]) or len(edges) >= R:
            continue
        cv = cand_vecs[j]
        if kept_vecs:
            diff = np.stack(kept_vecs) - cv[None, :]
            if occludes((diff * diff).sum(-1), cand_d[j], alpha).any():
                continue
        kept_vecs.append(cv)
        taken[j] = True
        if edge_ok[j]:
            edges.append(j)
    if keep_pruned:
        for j in order:
            if len(edges) >= R:
                break
            if not taken[j] and edge_ok[j] and np.isfinite(cand_d[j]):
                edges.append(j)
                taken[j] = True
    return np.asarray(edges, np.int64)


def greedy_candidates(neighbors: np.ndarray, x: np.ndarray,
                      queries: np.ndarray, entry: int, *, ef: int = 64,
                      live: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy best-first beam search over a padded (n, R) adjacency —
    greedy-search-guided candidate collection for insert-time repair
    (FreshDiskANN's insert; DESIGN.md §6).  ``live``: optional (n,) mask;
    dead nodes are traversed *through* but never returned as candidates.
    Returns (ids (B, ef), d2 (B, ef)), distance-sorted, sentinel ``n`` /
    ``inf`` padded."""
    n = x.shape[0]
    Bq = queries.shape[0]
    out_ids = np.full((Bq, ef), n, np.int64)
    out_d = np.full((Bq, ef), np.inf, np.float32)
    for b in range(Bq):
        q = queries[b]
        dv = x[entry] - q
        beam = {entry: float((dv * dv).sum())}
        checked: set = set()
        visited = {entry}
        while True:
            frontier = [(d, u) for u, d in beam.items() if u not in checked]
            if not frontier:
                break
            _, u = min(frontier)
            checked.add(u)
            nbrs = neighbors[u]
            nbrs = nbrs[nbrs < n]
            fresh = [v for v in nbrs if v not in visited]
            visited.update(fresh)
            for v in fresh:
                dv = x[v] - q
                beam[v] = float((dv * dv).sum())
            if len(beam) > ef:
                beam = dict(sorted(beam.items(), key=lambda kv: kv[1])[:ef])
        items = sorted(beam.items(), key=lambda kv: kv[1])
        if live is not None:
            items = [(u, d) for u, d in items if live[u]]
        items = items[:ef]
        for j, (u, d) in enumerate(items):
            out_ids[b, j] = u
            out_d[b, j] = d
    return out_ids, out_d


def patch_reverse_edges(neighbors: np.ndarray, x: np.ndarray,
                        src_ids: np.ndarray, n: int, R: int, *,
                        alpha: float = 1.2) -> np.ndarray:
    """Reverse-edge augmentation for freshly inserted nodes (in place;
    DESIGN.md §6): for every edge ``u -> v`` of a new node ``u`` in
    ``src_ids``, add the reverse ``v -> u``.  A free slot takes it
    directly; a full row is *re-pruned* — ``prune_one`` over v's current
    neighbours ∪ {u} — so the degree bound R is never exceeded and the row
    keeps the occlusion-diverse subset (FreshDiskANN's robust-prune on
    overflow).  Returns ``neighbors`` for convenience."""
    for u in np.asarray(src_ids, np.int64):
        for v in neighbors[u]:
            if v >= n or v == u:
                continue
            row = neighbors[v]
            deg = int((row < n).sum())
            if (row[:deg] == u).any():
                continue
            if deg < R:
                row[deg] = u
                continue
            cand = np.concatenate([row[:deg], [u]]).astype(np.int64)
            diff = x[cand] - x[v][None, :]
            cd = (diff * diff).sum(-1).astype(np.float32)
            kept = prune_one(x[cand], cd, R, alpha=alpha)
            new_row = np.full(row.shape[0], n, row.dtype)
            new_row[:len(kept)] = cand[kept]
            neighbors[v] = new_row
    return neighbors


def add_reverse_edges(neighbors: np.ndarray, n: int, R: int) -> np.ndarray:
    """Add reverse edges where slots allow (degree cap R).  Vectorised:
    incoming edges are ranked per destination and written into the free
    slots.  (A rare duplicate edge is harmless for traversal — the visited
    table deduplicates — so no per-edge membership check.)"""
    nb = neighbors.copy()
    deg = (nb < n).sum(axis=1).astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), nb.shape[1])
    dst = nb.reshape(-1).astype(np.int64)
    real = (dst < n) & (src != dst)
    src, dst = src[real], dst[real]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(dst, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(dst)) - starts[dst]
    slot = deg[dst] + rank
    ok = slot < R
    nb[dst[ok], slot[ok]] = src[ok]
    return nb


def bfs_reachable(neighbors: np.ndarray, n: int, entry: int) -> np.ndarray:
    """Vectorised BFS over the padded adjacency; returns (n,) bool."""
    reached = np.zeros(n, bool)
    frontier = np.array([entry])
    reached[entry] = True
    while len(frontier):
        nxt = neighbors[frontier].reshape(-1)
        nxt = nxt[nxt < n]
        nxt = np.unique(nxt)
        nxt = nxt[~reached[nxt]]
        reached[nxt] = True
        frontier = nxt
    return reached


def connect_components(neighbors: np.ndarray, x: np.ndarray, entry: int,
                       *, sample: int = 2048, seed: int = 0) -> np.ndarray:
    """NSG-style spanning repair: label weakly-connected components in one
    sweep, then link every non-core component to the entry component through
    its (approximately) nearest cross pair, so greedy search from the entry
    can reach the whole graph.

    Same links, in the same order and from the same random draws, as the
    reference; the members of every component come from one stable sort of
    the labels instead of a scan of all n labels per component, which made
    the reference O(n · components) — minutes at n = 1M with tens of
    thousands of unreachable nodes — and the core sample's norms are taken
    once per pass."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    nb = neighbors.copy()
    for _ in range(4):  # almost always 1 pass; re-check for rare overwrites
        comp = np.full(n, -1, np.int64)
        n_comp = 0
        todo = np.concatenate([[entry], np.arange(n)])
        for seed_node in todo:
            if comp[seed_node] >= 0:
                continue
            frontier = np.array([seed_node])
            comp[seed_node] = n_comp
            while len(frontier):
                nxt = nb[frontier].reshape(-1)
                nxt = nxt[nxt < n]
                # treat edges as undirected for labeling (reverse edges were
                # added; residual one-way edges still join weak components)
                nxt = np.unique(nxt)
                nxt = nxt[comp[nxt] < 0]
                comp[nxt] = n_comp
                frontier = nxt
            n_comp += 1
        if n_comp == 1:
            return nb
        order = np.argsort(comp, kind="stable")     # ascending ids per label
        bounds = np.searchsorted(comp[order], np.arange(n_comp + 1))
        core_ids = order[bounds[0]:bounds[1]]
        rs = core_ids if len(core_ids) <= sample else \
            rng.choice(core_ids, sample, replace=False)
        xr = x[rs]
        xr2 = (xr * xr).sum(-1)[None, :]            # pairwise_sq_dists' b2
        for c in range(1, n_comp):
            comp_ids = order[bounds[c]:bounds[c + 1]]
            cs = comp_ids if len(comp_ids) <= sample else \
                rng.choice(comp_ids, sample, replace=False)
            xc = x[cs]
            d2 = np.maximum((xc * xc).sum(-1)[:, None] + xr2
                            - 2.0 * (xc @ xr.T), 0.0)
            i, j = np.unravel_index(np.argmin(d2), d2.shape)
            a, b = int(rs[j]), int(cs[i])  # a in core, b in component
            for s, t in ((a, b), (b, a)):
                row = nb[s]
                deg = int((row < n).sum())
                if (row[:deg] == t).any():
                    continue
                slot = deg if deg < row.shape[0] else row.shape[0] - 1
                nb[s, slot] = t
        if bfs_reachable(nb, n, entry).all():
            return nb
    return nb


def build_graph(x: np.ndarray, R: int = 32, *, method: str = "auto",
                alpha: float = 1.2, knn_k: Optional[int] = None,
                seed: int = 0, reverse: bool = True,
                repair: bool = True, device=None,
                timings: Optional[Dict[str, float]] = None) -> Graph:
    """Construct a navigable graph.
    method: exact | clustered | nn_descent | auto.  ``nn_descent`` is the
    device-resident CAGRA-style builder (``core/device_build``):
    NN-descent candidate lists + device occlusion prune on ``device``
    (``None`` means the card); the other methods run on the host and
    ignore ``device``.  The reverse / connectivity passes are shared.
    ``timings``, when given, receives the wall seconds of ``knn``,
    ``prune`` and ``reverse_repair``."""
    n = x.shape[0]
    x = np.ascontiguousarray(x, np.float32)
    knn_k = knn_k or min(n - 1, 2 * R)
    if method == "auto":
        method = "exact" if n <= 50_000 else "clustered"
    if method == "nn_descent":
        from repro_torch.core import device_build
        return device_build.build_graph_device(
            x, R, alpha=alpha, knn_k=knn_k, seed=seed, reverse=reverse,
            repair=repair, device=device, timings=timings)
    t0 = time.perf_counter()
    if method == "exact":
        ids, dd = brute_knn(x, knn_k)
    elif method == "clustered":
        n_clusters = max(8, int(np.sqrt(n) / 4))
        ids, dd = clustered_knn(x, knn_k, n_clusters=n_clusters, seed=seed)
    else:
        raise ValueError(f"unknown build method {method!r} "
                         f"(exact | clustered | nn_descent | auto)")
    t1 = time.perf_counter()
    nb = occlusion_prune(x, ids, dd, R, alpha=alpha)
    t2 = time.perf_counter()
    if reverse:
        nb = add_reverse_edges(nb, n, R)
    if repair and n > 1:
        nb = connect_components(nb, x, medoid(x))
    if timings is not None:
        timings.update(knn=t1 - t0, prune=t2 - t1,
                       reverse_repair=time.perf_counter() - t2)
    return Graph(nb.astype(np.int32), n)


def medoid(x: np.ndarray, sample: int = 8192, seed: int = 0) -> int:
    """Entry point: the point nearest the dataset mean."""
    mu = x.mean(axis=0, keepdims=True)
    d2 = pairwise_sq_dists(mu, x)[0]
    return int(np.argmin(d2))
