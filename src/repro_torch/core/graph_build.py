"""Graph construction substrate — numpy copy of ``repro.core.graph_build``
(the port imports nothing of the JAX package): exact / clustered approximate
kNN graphs with HNSW-style occlusion pruning and reverse-edge augmentation.

PilotANN is construction-agnostic (it reuses the index's own build algorithm;
§A.2 shows orthogonality to HNSW vs NSG).  The vectorised NSW-family construction:
  1. kNN candidates (exact blockwise, or kmeans-bucketed approximate),
  2. occlusion pruning (the HNSW/NSG "heuristic"): keep neighbour c only if
     d(q, c) < alpha * min_{kept k} d(k, c),
  3. reverse edges + degree cap.

The same seed gives the same graph as the reference, array for array.  The
insert-repair primitives and the device NN-descent build wait for the
mutable index and the device build (ROADMAP A7).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
    can reach the whole graph."""
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
        core_ids = np.flatnonzero(comp == 0)
        rs = core_ids if len(core_ids) <= sample else \
            rng.choice(core_ids, sample, replace=False)
        for c in range(1, n_comp):
            comp_ids = np.flatnonzero(comp == c)
            cs = comp_ids if len(comp_ids) <= sample else \
                rng.choice(comp_ids, sample, replace=False)
            d2 = pairwise_sq_dists(x[cs], x[rs])
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
                repair: bool = True) -> Graph:
    """Construct a navigable graph.
    method: exact | clustered | auto (``nn_descent`` raises until ROADMAP A7
    ports the device build)."""
    n = x.shape[0]
    x = np.ascontiguousarray(x, np.float32)
    knn_k = knn_k or min(n - 1, 2 * R)
    if method == "auto":
        method = "exact" if n <= 50_000 else "clustered"
    if method == "nn_descent":
        raise NotImplementedError(
            "build_method='nn_descent' (device NN-descent build) is not "
            "ported yet: ROADMAP A7")
    if method == "exact":
        ids, dd = brute_knn(x, knn_k)
    elif method == "clustered":
        n_clusters = max(8, int(np.sqrt(n) / 4))
        ids, dd = clustered_knn(x, knn_k, n_clusters=n_clusters, seed=seed)
    else:
        raise ValueError(f"unknown build method {method!r} "
                         f"(exact | clustered | nn_descent | auto)")
    nb = occlusion_prune(x, ids, dd, R, alpha=alpha)
    if reverse:
        nb = add_reverse_edges(nb, n, R)
    if repair and n > 1:
        nb = connect_components(nb, x, medoid(x))
    return Graph(nb.astype(np.int32), n)


def medoid(x: np.ndarray, sample: int = 8192, seed: int = 0) -> int:
    """Entry point: the point nearest the dataset mean."""
    mu = x.mean(axis=0, keepdims=True)
    d2 = pairwise_sq_dists(mu, x)[0]
    return int(np.argmin(d2))
