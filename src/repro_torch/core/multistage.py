"""Multi-stage ANNS processing (PilotANN §4) — port of
``repro.core.multistage``.

  0  entry selection   — FES (the CUDA distance kernel behind
                         ``kernels/ops.fes_select`` on the card; the plain
                         ``fes_select_ref`` on the CPU — same ids)
  ①  pilot traversal   — compact subgraph + SVD-primary vectors (the CUDA
                         traversal kernels with ``use_pallas_traversal`` /
                         ``use_persistent_traversal``)
  ②  residual refine   — exact full distances for the pilot beam via the
                         SVD identity ‖x−q‖² = ‖xp−qp‖² + ‖xr−qr‖², then a
                         bounded (2-round) traversal on the subgraph with
                         full vectors
  ③  final traversal   — full graph + full vectors, seeded with ②'s beam

Stages ① and ② share a *compact* pilot id space, so stage ② inherits ①'s
visited filter directly; stage ③ lives in the full id space and rebuilds
its filter from the handed-over beam.  Stage ② is PyTorch ops (the
reference has no kernel for it); stage ③ runs whole in one launch of its
own CUDA kernel on the card (``final_spec``), and on the CPU as PyTorch
rounds, the reference's round.  With stages disabled this reduces to plain
greedy search (the ablation of Table 5), whose loop takes the same kernel.

Each entry point is a *program* (``core/traversal.py``):
``multistage_program`` / ``baseline_program`` yield their stage-① and
stage-③ convergence loops, and a ``traversal.Stage`` marker where each
stage starts (``stage0`` … ``stage3``; the baseline is one ``stage3``);
``multistage_search`` / ``baseline_search`` run them eagerly, and
``core/compiled.py`` captures them as CUDA graphs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.core import fes as F
from repro_torch.core import quant
from repro_torch.core import traversal as T

INF = float("inf")

# Per-stage stats: every value is a (B,) int32 tensor of per-query
# distance-computation counts.  Both search entry points return exactly the
# same key set.
StatsDict = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class SearchParams:
    """Per-call search knobs (the reference's, minus ``pallas_interpret``)."""
    k: int = 10              # results returned per query
    ef: int = 128            # stage-③ beam width (recall/latency dial)
    ef_pilot: int = 128      # stage-① beam width
    fes_L: int = 32          # entries returned by FES (stage-0 fan-in)
    refine_iters: int = 2    # stage-② bounded traversal rounds (paper: 2)
    use_fes: bool = True     # stage 0: FES entry selection vs coarse layer
    use_pilot: bool = True   # stage ①: pilot subgraph traversal
    use_refine: bool = True  # stage ②: residual refinement
    visited_mode: str = "bloom"   # bloom | exact visited-set structure
    bloom_bits: int = 16384  # bloom filter width per query (bits)
    max_iters: int = 512     # safety bound on expansion rounds per stage
    # multi-frontier expansion: frontier_width drives stages ②/③ (and the
    # baseline); frontier_width_pilot drives stage ①.
    frontier_width: int = 1
    frontier_width_pilot: int = 1
    # stage ① via the per-hop CUDA kernel (one launch per round)
    use_pallas_traversal: bool = False
    # stage ① via the persistent CUDA kernel (one launch for the search)
    use_persistent_traversal: bool = False


# The reference's ladder of padded batch sizes: the engine and the stage
# pipeline pad every batch to a rung, so the compiled-call cache
# (``core/compiled.py``) holds a small fixed set of shapes.
BATCH_BUCKETS: Tuple[int, ...] = (8, 16, 32, 64, 128)


def bucket_size(B: int, buckets: Tuple[int, ...] = BATCH_BUCKETS) -> int:
    """The smallest ladder rung ``>= B``, or the next multiple of the top
    rung above the ladder."""
    for b in buckets:
        if B <= b:
            return b
    top = buckets[-1]
    return -(-B // top) * top


def pad_to_bucket(queries: torch.Tensor,
                  buckets: Tuple[int, ...] = BATCH_BUCKETS
                  ) -> Tuple[torch.Tensor, int]:
    """Pad a query batch to its ladder bucket (zero rows); returns
    ``(padded, original_B)``.  Callers slice results back to
    ``original_B``.  Padded rows are independent under the batched
    traversal (every per-query op is row-local and a converged row is a
    fixed point), so real rows keep their ids; on the card their distances
    may move in the last bits, where a library picks another kernel for
    another number of rows."""
    B = queries.shape[0]
    nb = bucket_size(B, buckets)
    if nb == B:
        return queries, B
    return torch.nn.functional.pad(queries, (0, 0, 0, nb - B)), B


def pilot_spec(params: SearchParams) -> T.TraversalSpec:
    """Stage ①'s traversal: the pilot beam, on the CUDA kernels when asked."""
    return T.TraversalSpec(ef=params.ef_pilot, visited_mode=params.visited_mode,
                           bloom_bits=params.bloom_bits,
                           max_iters=params.max_iters,
                           frontier_width=params.frontier_width_pilot,
                           use_pallas=(params.use_pallas_traversal or
                                       params.use_persistent_traversal),
                           use_persistent=params.use_persistent_traversal)


def final_spec(params: SearchParams) -> T.TraversalSpec:
    """Stage ③'s (and the baseline's) traversal: one launch of its CUDA
    kernel where ``traversal.takes_final_kernel`` allows (the card, no
    hooks, a state that fits), torch rounds elsewhere."""
    return T.TraversalSpec(ef=params.ef, visited_mode=params.visited_mode,
                           bloom_bits=params.bloom_bits,
                           max_iters=params.max_iters,
                           frontier_width=params.frontier_width,
                           final_kernel=True)


def fes_entries(arrays: Dict[str, torch.Tensor], params: SearchParams,
                q_primary: torch.Tensor) -> torch.Tensor:
    """Stage 0: the (B, fes_L) compact pilot ids FES picks — the CUDA
    distance kernel behind ``kernels/ops.fes_select`` on the card, the
    plain ``fes_select_ref`` on the CPU."""
    fes_args = (q_primary, arrays["fes_centroids"], arrays["fes_entries"],
                arrays["fes_entry_ids"], arrays["fes_valid"])
    fes_kw = dict(entries_scale=arrays.get("fes_entries_scale"),
                  entries_codebook=arrays.get("fes_entries_codebook"),
                  tombstone=arrays.get("pilot_tombstone"))
    if q_primary.device.type == "cuda":
        from repro_torch.kernels import ops
        return ops.fes_select(*fes_args, L=params.fes_L, **fes_kw)[0]
    return F.fes_select_ref(*fes_args, params.fes_L, **fes_kw)[0]


def hierarchical_entries(arrays: Dict[str, torch.Tensor],
                         queries: torch.Tensor, params: SearchParams,
                         n_out: int = 4
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HNSW-hierarchy analogue: score the coarse sampled layer exactly and
    take the top entries (ties toward the lower slot, as ``lax.top_k``).
    Returns (coarse slot indices (B, n_out), per-query cost)."""
    cv = arrays["coarse_vecs"][:-1]                # (m, d), drop sentinel row
    d2 = T.sq_dists(queries, cv)                   # (B, m)
    _, idx = F.topk_smallest(d2, n_out)
    cost = torch.full((queries.shape[0],), cv.shape[0], dtype=torch.int32,
                      device=queries.device)
    return idx, cost


def refine_stage(arrays: Dict[str, torch.Tensor], params: SearchParams,
                 queries: torch.Tensor, cand_id: torch.Tensor,
                 cand_dp: torch.Tensor, visited: torch.Tensor = None, *,
                 dist_full_fn=None, dist_res_fn=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage ②: exact re-rank of the pilot beam, then a bounded traversal
    on the compact subgraph with FULL vectors (neighbours from the compact
    table, distances from ``rot_vecs`` via ``pilot_to_full``).  For an fp32
    pilot the SVD identity reuses the primary term; a quantized pilot's
    beam distances carry its quantization error, so they are re-scored
    from ``rot_vecs`` instead (and only that branch may run for int4/pq,
    whose ``primary`` rows are packed).

    Returns ``(seed_id, seed_d, refine_dist)``: the refined beam mapped back
    to FULL ids + its exact distances (stage ③'s seed), and the per-query
    distance-computation count.

    Pod sharding: ``dist_full_fn(queries, full_ids)`` and
    ``dist_res_fn(q_residual, full_ids)`` replace the gathers from
    ``rot_vecs`` (the exact re-rank of a quantized pilot and the bounded
    traversal) and from ``residual`` (the fp32 pilot's re-score) with
    scoring by the shards that own the rows.  They must be exact: they
    replace a gather + ``sq_dists``, not an approximation of it.  Both
    default to the gathers."""
    nk = arrays["pilot_to_full"].shape[0] - 1
    ptf = arrays["pilot_to_full"].long()
    Bq = queries.shape[0]
    ptomb = arrays.get("pilot_tombstone")
    if ptomb is not None:
        cand_id = T.sentinel_mask(ptomb, cand_id, nk)
    valid = cand_id < nk
    cand_full = ptf[cand_id.long()]
    if dist_full_fn is None:
        dist_full_fn = lambda qs, ids: T.sq_dists(qs, arrays["rot_vecs"][ids])
    if dist_res_fn is None:
        dist_res_fn = lambda qs, ids: T.sq_dists(qs, arrays["residual"][ids])
    if arrays["primary"].dtype != torch.float32:   # quantized: exact re-score
        d_full = torch.where(valid, dist_full_fn(queries, cand_full), INF)
    else:                                          # exact: SVD identity
        qr = queries[:, arrays["primary"].shape[1]:]
        d_res = dist_res_fn(qr, cand_full)
        d_full = torch.where(valid, cand_dp + d_res, INF)
    n_rerank = valid.sum(1, dtype=torch.int32)

    def dist2(qs, ids, fresh):
        return dist_full_fn(qs, ptf[ids.long()])
    spec2 = T.TraversalSpec(ef=params.ef, visited_mode=params.visited_mode,
                            bloom_bits=params.bloom_bits,
                            frontier_width=params.frontier_width)
    st2 = T.greedy_search(spec2, queries, arrays["sub_neighbors"],
                          arrays["rot_vecs"], nk,
                          entry_ids=torch.full((Bq, 1), nk, dtype=torch.int32,
                                               device=queries.device),
                          iters=params.refine_iters, visited=visited,
                          extra_id=cand_id, extra_d=d_full, dist_fn=dist2,
                          tombstone=ptomb)
    return (ptf[st2.cand_id.long()].to(torch.int32), st2.cand_d,
            n_rerank + st2.n_dist)


def multistage_search(arrays: Dict[str, torch.Tensor], params: SearchParams,
                      queries: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, StatsDict]:
    """``multistage_program`` run eagerly."""
    return T.run_program(multistage_program(arrays, params, queries))


def multistage_program(arrays: Dict[str, torch.Tensor], params: SearchParams,
                       queries: torch.Tensor) -> T.Program:
    """arrays: tensors built by engine.PilotANNIndex (or carried over from
    the reference with ``engine.arrays_from_numpy``) —
      full_neighbors (n+1, R), rot_vecs (n+1, d), residual (n+1, dr);
      compact pilot tables sub_neighbors (nk+1, R) int16/int32,
      primary (nk+1, ·) in any pilot encoding [+ primary_scale (dp,) or
      primary_codebook (dp, m·ksub)], pilot_to_full (nk+1,);
      fes_centroids (r, d), fes_entries (r, C, ·) [+ fes_entries_scale /
      fes_entries_codebook], fes_entry_ids (r, C) *pilot* ids,
      fes_valid (r, C); coarse layer + pilot_default_entry.
    Optional ``tombstone`` (n+1,) / ``pilot_tombstone`` (nk+1,) deletion
    bitmaps are honoured as in the reference.
    Queries must already be SVD-rotated (the engine handles it).
    Returns (ids (B, k), dists (B, k), stats).  Yields a ``Stage`` marker
    at the start of each stage that runs; stage ③ holds the top-k."""
    yield T.Stage("stage0")
    n = arrays["rot_vecs"].shape[0] - 1
    nk = arrays["pilot_to_full"].shape[0] - 1      # compact pilot id space
    pilot_scale = arrays.get("primary_scale")
    pilot_codebook = arrays.get("primary_codebook")
    # true primary width: int4/pq rows are packed narrower than dp
    dp = quant.primary_dim(arrays["primary"], pilot_scale,
                           codebook=pilot_codebook)
    Bq = queries.shape[0]
    dev = queries.device
    stats: StatsDict = {}
    q_primary = queries[:, :dp].contiguous()
    ptf = arrays["pilot_to_full"].long()
    tomb = arrays.get("tombstone")
    ptomb = arrays.get("pilot_tombstone")
    zeros = torch.zeros((Bq,), dtype=torch.int32, device=dev)

    # ---- stage 0: entry selection --------------------------------------
    entry_full = None          # full-id entries (pilot disabled paths)
    if params.use_fes:
        entry_pilot = fes_entries(arrays, params, q_primary)
        if not params.use_pilot:
            entry_full = ptf[entry_pilot.long()]
        # FES cost: one centroid pass + one cluster pass (counted per query)
        stats["fes_dist"] = torch.full(
            (Bq,), arrays["fes_centroids"].shape[0] +
            arrays["fes_entries"].shape[1], dtype=torch.int32, device=dev)
    else:
        # coarse layer holds full-d vectors; select entries with full queries
        slots, entry_cost = hierarchical_entries(arrays, queries, params)
        entry_full = arrays["coarse_ids"][slots]
        # pilot entries: coarse nodes mapped into the compact subgraph
        # (sentinel when sampled out) + the guaranteed pilot medoid
        entry_pilot = torch.cat(
            [arrays["coarse_pilot_ids"][slots],
             arrays["pilot_default_entry"].expand(Bq, 1)], dim=1)
        stats["fes_dist"] = entry_cost

    # ---- stage ①: pilot traversal (compact subgraph, primary dims) -----
    if params.use_pilot:
        yield T.Stage("stage1")
        st1 = yield from T.greedy_program(
            pilot_spec(params), q_primary, arrays["sub_neighbors"],
            arrays["primary"], nk, entry_pilot, vec_scale=pilot_scale,
            vec_codebook=pilot_codebook, tombstone=ptomb)
        stats["pilot_dist"] = st1.n_dist
        stats["pilot_hops"] = st1.n_hops
        stats["pilot_expanded"] = st1.n_exp
        cand_id, cand_dp = st1.cand_id, st1.cand_d       # compact pilot ids
        cand_full = ptf[cand_id.long()]                  # (B, ef1) full ids
        pilot_visited = st1.visited
    else:
        stats["pilot_dist"] = stats["pilot_hops"] = zeros
        stats["pilot_expanded"] = zeros

    # ---- stage ②: residual refinement (inherits ①'s visited filter) ----
    seed_id = seed_d = None
    if params.use_refine and params.use_pilot:
        yield T.Stage("stage2")
        seed_id, seed_d, stats["refine_dist"] = refine_stage(
            arrays, params, queries, cand_id, cand_dp, visited=pilot_visited)
    else:
        stats["refine_dist"] = zeros

    # ---- stage ③: final traversal (full graph + vectors) ---------------
    yield T.Stage("stage3")
    spec3 = final_spec(params)
    if seed_id is not None:
        st3 = yield from T.greedy_program(
            spec3, queries, arrays["full_neighbors"], arrays["rot_vecs"], n,
            entry_ids=torch.full((Bq, 1), n, dtype=torch.int32, device=dev),
            extra_id=seed_id, extra_d=seed_d, tombstone=tomb)
    elif params.use_pilot:  # pilot w/o refine: re-score pilot beam fully
        st3 = yield from T.greedy_program(
            spec3, queries, arrays["full_neighbors"], arrays["rot_vecs"], n,
            entry_ids=cand_full, tombstone=tomb)
    else:
        st3 = yield from T.greedy_program(
            spec3, queries, arrays["full_neighbors"], arrays["rot_vecs"], n,
            entry_ids=entry_full, tombstone=tomb)
    stats["final_dist"] = st3.n_dist
    stats["final_hops"] = st3.n_hops
    stats["final_expanded"] = st3.n_exp
    stats["total_cpu_dist"] = stats["refine_dist"] + stats["final_dist"]

    ids, dists = T.topk_from_state(st3, params.k)
    return ids, dists, stats


def baseline_search(arrays: Dict[str, torch.Tensor], params: SearchParams,
                    queries: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, StatsDict]:
    """``baseline_program`` run eagerly."""
    return T.run_program(baseline_program(arrays, params, queries))


def baseline_program(arrays: Dict[str, torch.Tensor], params: SearchParams,
                     queries: torch.Tensor) -> T.Program:
    """Single-stage greedy search on the full index (the HNSW-CPU baseline),
    with the same ``stats`` schema as ``multistage_search``: the skipped
    stages report zero, the coarse entry-layer scan is charged as
    ``fes_dist`` and included in ``total_cpu_dist``.  Its one stage is
    marked ``stage3``."""
    yield T.Stage("stage3")
    n = arrays["rot_vecs"].shape[0] - 1
    slots, entry_cost = hierarchical_entries(arrays, queries, params)
    entries = arrays["coarse_ids"][slots]
    st = yield from T.greedy_program(final_spec(params), queries,
                                     arrays["full_neighbors"],
                                     arrays["rot_vecs"], n, entries,
                                     tombstone=arrays.get("tombstone"))
    ids, dists = T.topk_from_state(st, params.k)
    zeros = torch.zeros_like(st.n_dist)
    return ids, dists, {"fes_dist": entry_cost,
                        "pilot_dist": zeros, "pilot_hops": zeros,
                        "pilot_expanded": zeros, "refine_dist": zeros,
                        "final_dist": st.n_dist, "final_hops": st.n_hops,
                        "final_expanded": st.n_exp,
                        "total_cpu_dist": st.n_dist + entry_cost}
