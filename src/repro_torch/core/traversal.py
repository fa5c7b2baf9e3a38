"""Batched greedy graph traversal (Algorithm 1 of the paper) in PyTorch.

Port of ``repro.core.traversal``.  A query batch advances one W-wide
neighbour-expansion round per step: the top ``W = spec.frontier_width``
unchecked beam entries expand together, their up-to W·R neighbours are
scored in one ``(B, W·R, d)`` block and merged into the sorted ``(B, ef)``
beam with a stable sort.  Visited tracking is a bloom filter (paper §4.3)
or an exact bitmap.

With ``spec.use_pallas`` a round runs as one hand-written CUDA kernel
(``kernels/traversal_kernel.fused_traversal_hop``), and with
``spec.use_persistent`` the whole search does
(``fused_pilot_search``).  The field names are the reference's, so a
reader finds the counterpart; on CPU tensors both wrappers run their plain
PyTorch versions.  A ``spec.final_kernel`` search (stage ③'s,
``multistage.final_spec``) runs whole in one launch of
``fused_final_search`` where ``takes_final_kernel`` finds that it can (the
card, no hooks, a state that fits), and as torch rounds elsewhere — on the
CPU always, so the CPU mirrors the reference's rounds.

The traversal returns per-query distance-computation counts — the unit in
which the paper reports all of its complexity results.

A search runs as a *program*: a generator that yields each loop it runs to
convergence (``Loop``) and gets the converged state back, and a ``Stage``
marker at the start of each of its stages.  ``run_program`` drives one
eagerly, in a span per stage (``runtime/trace.py``); ``core/compiled.py``
captures the code between the loops, and ``CHUNK`` rounds of each loop, as
CUDA graphs, with a timing event at each marker.  Both run a loop the same
way (``run_to_convergence``): ``CHUNK`` rounds, then one host test, each
counted (``search.host_tests``, ``search.rounds``).

Ties: ``jnp.argsort`` is stable, so every sort here is
``torch.sort(stable=True)``; ``jnp.lexsort((d, ids))`` becomes two stable
sorts (by d, then by id).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from functools import partial
from typing import Callable, Generator, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import bloom as B
from repro_torch.core import quant
from repro_torch.runtime import trace

INF = float("inf")

# Rounds between two host tests of convergence.  A round on a converged
# query is a fixed point of every field of its state (counters included),
# so the rounds a batch runs past its convergence change nothing; 8 cuts
# the host syncs of a stage-③ search (~130 rounds at ef 128) from one a
# round to ~17, and wastes at most 7 rounds on a converged batch.
CHUNK = 8


class SearchState(NamedTuple):
    cand_id: torch.Tensor   # (B, ef) int32, sorted by distance; sentinel = n
    cand_d: torch.Tensor    # (B, ef) float32
    checked: torch.Tensor   # (B, ef) bool
    visited: torch.Tensor   # (B, n_bits/n+1) bool filter
    n_dist: torch.Tensor    # (B,) int32 distance-computation counter
    n_hops: torch.Tensor    # (B,) int32 expansion *rounds* with work
    n_exp: torch.Tensor     # (B,) int32 candidates actually expanded


@dataclass(frozen=True)
class TraversalSpec:
    ef: int
    visited_mode: str = "bloom"      # bloom | exact
    bloom_bits: int = 16384
    max_iters: int = 512
    # multi-frontier expansion: expand the top-W unchecked beam entries per
    # round.  W=1 is bit-identical to the classic single-frontier round.
    frontier_width: int = 1
    # one CUDA kernel per expansion round (kernels/traversal_kernel.py)
    use_pallas: bool = False
    # the whole search in one persistent CUDA kernel; requires use_pallas
    use_persistent: bool = False
    # stage ③'s search (``multistage.final_spec``): one persistent launch
    # of its own kernel wherever ``takes_final_kernel`` allows
    final_kernel: bool = False


def sentinel_mask(tombstone: torch.Tensor, ids: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Every id whose bit is set in the ``(n+1,)`` tombstone bitmap becomes
    the sentinel ``n`` (dtype-preserving, so int16 pilot tables stay
    int16).  An all-false bitmap is the identity."""
    t = tombstone[ids.long().clamp(0, tombstone.shape[0] - 1)]
    return ids.masked_fill(t, n)


def sq_dists(q: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """q: (B, d); vecs: (B, R, d) — or (m, d) shared across the batch —
    -> (B, R) / (B, m) squared euclidean, fp32, as ``max(qn + vn − 2·dot, 0)``
    (the reference's single source of truth for that identity)."""
    q = q.float()
    vecs = vecs.float()
    qn = (q * q).sum(-1)[:, None]
    vn = (vecs * vecs).sum(-1)
    if vecs.ndim == 2:                     # one shared (m, d) table
        return torch.clamp_min(qn + vn[None, :] - 2.0 * (q @ vecs.T), 0.0)
    dot = torch.einsum("bd,brd->br", q, vecs)
    return torch.clamp_min(qn + vn - 2.0 * dot, 0.0)


def _visited_init(spec: TraversalSpec, batch: int, n: int, device):
    if spec.visited_mode == "bloom":
        return B.bloom_init(batch, spec.bloom_bits, device=device)
    return B.exact_init(batch, n, device=device)


def _visited_test(spec: TraversalSpec, filt, ids):
    return (B.bloom_test if spec.visited_mode == "bloom"
            else B.exact_test)(filt, ids)


def _visited_insert(spec: TraversalSpec, filt, ids, mask):
    return (B.bloom_insert if spec.visited_mode == "bloom"
            else B.exact_insert)(filt, ids, mask)


def init_state(spec: TraversalSpec, queries: torch.Tensor,
               entry_ids: torch.Tensor, vector_table: torch.Tensor, n: int,
               visited: Optional[torch.Tensor] = None,
               extra_id: Optional[torch.Tensor] = None,
               extra_d: Optional[torch.Tensor] = None,
               vec_scale: Optional[torch.Tensor] = None,
               vec_codebook: Optional[torch.Tensor] = None) -> SearchState:
    """Build the initial beam from entry points (+ optionally pre-scored
    candidates handed over from an earlier stage).  ``vec_scale`` (int8 /
    int4) and ``vec_codebook`` (pq) decode a quantized table
    (``quant.decode_rows``, the identity for exact tables).

    ``vector_table`` is the padded ``(n+1, d)`` table (the reference takes it
    without its sentinel row and re-appends a zero row; an entry at the
    sentinel is masked to +inf either way, so gathering from the padded
    table directly gives the same state without an O(n·d) copy)."""
    Bq = entry_ids.shape[0]
    entry_ids = entry_ids.to(torch.int32)
    valid = entry_ids < n
    evecs = quant.decode_rows(vector_table[entry_ids.long()], vec_scale,
                              codebook=vec_codebook)      # (B, E, d)
    d = torch.where(valid, sq_dists(queries, evecs), INF)
    n_dist = valid.sum(1, dtype=torch.int32)
    if extra_id is not None:
        entry_ids = torch.cat([extra_id.to(torch.int32), entry_ids], dim=1)
        d = torch.cat([extra_d.float(), d], dim=1)

    # dedupe identical ids (keep best distance): sort by (id, d), mask repeats
    o = torch.sort(d, dim=1, stable=True).indices
    sid, sd = entry_ids.gather(1, o), d.gather(1, o)
    o = torch.sort(sid, dim=1, stable=True).indices
    sid, sd = sid.gather(1, o), sd.gather(1, o)
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    sd = sd.masked_fill(dup, INF)
    sid = sid.masked_fill(dup, n)

    # sort by distance, pad/trim to ef
    k = spec.ef
    o = torch.sort(sd, dim=1, stable=True).indices
    sid, sd = sid.gather(1, o), sd.gather(1, o)
    if sid.shape[1] >= k:
        cand_id, cand_d = sid[:, :k], sd[:, :k]
    else:
        pad = k - sid.shape[1]
        cand_id = torch.nn.functional.pad(sid, (0, pad), value=n)
        cand_d = torch.nn.functional.pad(sd, (0, pad), value=INF)

    live = cand_id < n
    filt = (visited if visited is not None
            else _visited_init(spec, Bq, n, queries.device))
    filt = _visited_insert(spec, filt, cand_id.masked_fill(~live, 0), live)
    z = torch.zeros((Bq,), dtype=torch.int32, device=queries.device)
    return SearchState(cand_id=cand_id.contiguous(),
                       cand_d=cand_d.contiguous(), checked=~live,
                       visited=filt, n_dist=n_dist, n_hops=z, n_exp=z)


def _frontier(state: SearchState, n: int, W: int):
    """Top-W unchecked candidates per query: the beam is distance-sorted, so
    the first W unchecked slots are the W best (rows with none stay idle).
    Returns (unchecked, cum, sel)."""
    unchecked = ~state.checked & (state.cand_id < n)
    cum = unchecked.to(torch.int32).cumsum(1)
    return unchecked, cum, unchecked & (cum <= W)


def expansion_round(spec: TraversalSpec, state: SearchState,
                    queries: torch.Tensor, neighbor_table: torch.Tensor,
                    vector_table: torch.Tensor, n: int,
                    nbr_fn=None, dist_fn=None,
                    vec_scale: Optional[torch.Tensor] = None,
                    vec_codebook: Optional[torch.Tensor] = None,
                    tombstone: Optional[torch.Tensor] = None
                    ) -> SearchState:
    """One synchronous W-wide neighbour-expansion round for the whole batch.

    Visited filtering is *sequential per frontier* — frontier ``w`` is
    tested against the filter including frontiers ``< w``'s inserts — so a
    node reachable from two frontiers in the same round is scored once;
    within one frontier, duplicates are each scored.  The merge is a stable
    sort of ``[beam ; new]``: ties keep beam-first order.

    ``nbr_fn(u) -> (B, R)`` and ``dist_fn(queries, ids, fresh)`` override
    the table lookups (stage ② scores full vectors through the compact
    ids this way); ``vec_scale``/``vec_codebook`` decode a quantized
    ``vector_table``.  ``tombstone``: optional (n+1,) deletion bitmap; a
    tombstoned neighbour reads as the sentinel (the kernel tests its bit,
    the torch round masks the gathered rows, never the whole table)."""
    if spec.use_pallas and nbr_fn is None and dist_fn is None:
        return _kernel_round(spec, state, queries, neighbor_table,
                             vector_table, n, vec_scale, vec_codebook,
                             tombstone)
    return expand_round(spec, state, queries, neighbor_table, vector_table,
                        n, nbr_fn, dist_fn, vec_scale, vec_codebook,
                        tombstone)[0]


def expand_round(spec: TraversalSpec, state: SearchState,
                 queries: torch.Tensor, neighbor_table: torch.Tensor,
                 vector_table: torch.Tensor, n: int, nbr_fn=None,
                 dist_fn=None, vec_scale: Optional[torch.Tensor] = None,
                 vec_codebook: Optional[torch.Tensor] = None,
                 tombstone: Optional[torch.Tensor] = None
                 ) -> Tuple[SearchState, torch.Tensor]:
    """The plain body of ``expansion_round``; also returns the (B, W·R)
    ``fresh`` mask (the per-hop kernel's extra output).  ``tombstone``
    masks each frontier's gathered ``(B, R)`` neighbour row, which equals
    gathering from the masked table (the sentinel's own bit is clear); an
    ``nbr_fn`` answers for its own rows, as in the reference."""
    W = spec.frontier_width
    unchecked, cum, sel = _frontier(state, n, W)
    has_work = unchecked.any(1)
    checked = state.checked | sel
    n_exp = state.n_exp + sel.sum(1, dtype=torch.int32)

    visited = state.visited
    nbrs_w, fresh_w = [], []
    for w in range(W):
        mask_w = sel & (cum == w + 1)                     # w-th frontier slot
        u_w = torch.where(mask_w.any(1),
                          state.cand_id.masked_fill(~mask_w, 0).sum(1), n)
        if nbr_fn is None:
            nw = neighbor_table[u_w.long()].to(torch.int32)   # (B, R)
            if tombstone is not None:
                nw = sentinel_mask(tombstone, nw, n)
        else:
            nw = nbr_fn(u_w).to(torch.int32)
        vw = nw < n
        key = nw.masked_fill(~vw, 0)
        fw = vw & ~_visited_test(spec, visited, key)
        visited = _visited_insert(spec, visited, key, fw)
        nbrs_w.append(nw)
        fresh_w.append(fw)
    nbrs = torch.cat(nbrs_w, dim=1)                       # (B, W·R)
    fresh = torch.cat(fresh_w, dim=1)

    if dist_fn is None:
        nvecs = quant.decode_rows(vector_table[nbrs.long()], vec_scale,
                                  codebook=vec_codebook)  # (B, W·R, d)
        d = torch.where(fresh, sq_dists(queries, nvecs), INF)
    else:
        d = torch.where(fresh, dist_fn(queries, nbrs, fresh), INF)
    n_dist = state.n_dist + fresh.sum(1, dtype=torch.int32)

    # merge beam with fresh neighbours (stable: ties keep beam-first order)
    ef = state.cand_id.shape[1]
    all_id = torch.cat([state.cand_id, nbrs.masked_fill(~fresh, n)], dim=1)
    all_d = torch.cat([state.cand_d, d], dim=1)
    all_ck = torch.cat([checked, ~fresh], dim=1)
    order = torch.sort(all_d, dim=1, stable=True).indices[:, :ef]
    return SearchState(
        cand_id=all_id.gather(1, order),
        cand_d=all_d.gather(1, order),
        checked=all_ck.gather(1, order),
        visited=visited,
        n_dist=n_dist,
        n_hops=state.n_hops + has_work.to(torch.int32),
        n_exp=n_exp,
    ), fresh


def _kernel_round(spec: TraversalSpec, state: SearchState,
                  queries: torch.Tensor, neighbor_table: torch.Tensor,
                  vector_table: torch.Tensor, n: int,
                  vec_scale: Optional[torch.Tensor] = None,
                  vec_codebook: Optional[torch.Tensor] = None,
                  tombstone: Optional[torch.Tensor] = None) -> SearchState:
    """Fused expansion round: the whole W-wide hop body is one kernel
    launch; only the counters are kept here."""
    from repro_torch.kernels.traversal_kernel import fused_traversal_hop

    unchecked, _, sel = _frontier(state, n, spec.frontier_width)
    new_id, new_d, new_ck, visited, fresh = fused_traversal_hop(
        queries, neighbor_table, vector_table, state.cand_id, state.cand_d,
        state.checked, state.visited, n, width=spec.frontier_width,
        visited_mode=spec.visited_mode, vec_scale=vec_scale,
        vec_codebook=vec_codebook, tombstone=tombstone)
    return SearchState(
        cand_id=new_id, cand_d=new_d, checked=new_ck, visited=visited,
        n_dist=state.n_dist + fresh.sum(1, dtype=torch.int32),
        n_hops=state.n_hops + unchecked.any(1).to(torch.int32),
        n_exp=state.n_exp + sel.sum(1, dtype=torch.int32),
    )


def takes_final_kernel(spec: TraversalSpec, device: torch.device,
                       neighbor_table: Optional[torch.Tensor],
                       vector_table: torch.Tensor, visited: torch.Tensor, *,
                       hooked: bool,
                       vec_scale: Optional[torch.Tensor] = None,
                       vec_codebook: Optional[torch.Tensor] = None) -> bool:
    """Whether a ``spec.final_kernel`` search runs as one launch of
    ``fused_final_search``: on ``cuda``, with no ``nbr_fn``/``dist_fn``
    hook (``hooked``), and with a state (the neighbour rows, the filter
    ``visited``, ``vector_table``'s rows) that fits the kernel's shared
    memory — an exact bitmap over a large ``n`` does not.  Decided from
    the device and the shapes alone, before any capture; reads no data and
    needs no card."""
    if not spec.final_kernel or hooked or device.type != "cuda":
        return False
    from repro_torch.kernels.traversal_kernel import SMEM_LIMIT, launch_smem
    return launch_smem(vector_table, ef=spec.ef, width=spec.frontier_width,
                       R=neighbor_table.shape[1], vbits=visited.shape[1],
                       vec_scale=vec_scale,
                       vec_codebook=vec_codebook) <= SMEM_LIMIT


class Loop(NamedTuple):
    """A convergence loop that a search program hands to its driver:
    apply ``round_fn`` to ``state`` until no query has an unchecked
    candidate, at most ``max_rounds`` times."""
    round_fn: Callable[[SearchState], SearchState]
    state: SearchState
    n: int
    max_rounds: int


class Stage(NamedTuple):
    """The marker a search program yields where one of its stages starts
    (``stage0`` … ``stage3``); it is sent ``None`` back.  What follows, up
    to the next marker, is that stage's work: ``run_program`` runs it in
    the span ``repro_torch.<name>``, a captured graph records a timing
    event at the marker (``core/compiled.py``)."""
    name: str


# a search program: yields its loops and stage markers, is sent each loop's
# final state (``None`` for a marker), and returns its result
Program = Generator[Union[Loop, Stage], Optional[SearchState], object]


def greedy_search(spec: TraversalSpec, queries: torch.Tensor,
                  neighbor_table: torch.Tensor, vector_table: torch.Tensor,
                  n: int, entry_ids: torch.Tensor, **kw) -> SearchState:
    """``greedy_program`` run eagerly (``run_program``)."""
    return run_program(greedy_program(spec, queries, neighbor_table,
                                      vector_table, n, entry_ids, **kw))


def greedy_program(spec: TraversalSpec, queries: torch.Tensor,
                   neighbor_table: torch.Tensor, vector_table: torch.Tensor,
                   n: int, entry_ids: torch.Tensor, *,
                   iters: Optional[int] = None,
                   visited: Optional[torch.Tensor] = None,
                   extra_id: Optional[torch.Tensor] = None,
                   extra_d: Optional[torch.Tensor] = None,
                   nbr_fn=None, dist_fn=None,
                   vec_scale: Optional[torch.Tensor] = None,
                   vec_codebook: Optional[torch.Tensor] = None,
                   tombstone: Optional[torch.Tensor] = None) -> Program:
    """Greedy best-first search (Algorithm 1), batched, W-wide per round,
    as a program (module docstring).

    neighbor_table: (n+1, R) padded adjacency (row n = sentinel row).
    vector_table:   (n+1, d) vectors with a zero row at n, stored fp32,
    bf16, int8, nibble-packed int4 or pq codes (``core/quant.py``); pass
    ``vec_scale`` for int8/int4 and ``vec_codebook`` for pq.
    tombstone: optional (n+1,) bool deletion bitmap; tombstoned ids are
    sentinel-masked out of the entries and the handed-over beam before the
    search starts, and out of the adjacency where each round reads it (the
    kernels take the bitmap as an operand, the torch round masks the rows
    it gathers), so no masked copy of the table is made.
    iters: if given, runs a fixed number of rounds and yields nothing;
    otherwise yields one ``Loop`` to convergence (no unchecked candidate
    anywhere) with spec.max_iters as a safety bound.  With
    spec.use_persistent (and no hooks) the whole loop runs inside one
    persistent kernel instead, and so does a spec.final_kernel search where
    ``takes_final_kernel`` allows; a converged round is a fixed point, so
    the rounds a launch runs equal the loop's.
    """
    if tombstone is not None:
        entry_ids = sentinel_mask(tombstone, entry_ids, n)
        if extra_id is not None:
            dead = tombstone[extra_id.long().clamp(0, n)]
            extra_id = extra_id.masked_fill(dead, n)
            extra_d = extra_d.masked_fill(dead, INF)
    state = init_state(spec, queries, entry_ids, vector_table, n,
                       visited=visited, extra_id=extra_id, extra_d=extra_d,
                       vec_scale=vec_scale, vec_codebook=vec_codebook)

    hooked = nbr_fn is not None or dist_fn is not None
    whole = None
    if spec.use_pallas and spec.use_persistent and not hooked:
        from repro_torch.kernels.traversal_kernel import fused_pilot_search
        whole = fused_pilot_search
    elif takes_final_kernel(spec, queries.device, neighbor_table,
                            vector_table, state.visited, hooked=hooked,
                            vec_scale=vec_scale, vec_codebook=vec_codebook):
        from repro_torch.kernels.traversal_kernel import fused_final_search
        whole = fused_final_search
    if whole is not None:
        rounds = iters if iters is not None else spec.max_iters
        nid, nd, nck, nvis, d_dist, d_hops, d_exp = whole(
            queries, neighbor_table, vector_table, state.cand_id,
            state.cand_d, state.checked, state.visited, n, rounds=rounds,
            width=spec.frontier_width, visited_mode=spec.visited_mode,
            vec_scale=vec_scale, vec_codebook=vec_codebook,
            tombstone=tombstone)
        return SearchState(cand_id=nid, cand_d=nd, checked=nck,
                           visited=nvis, n_dist=state.n_dist + d_dist,
                           n_hops=state.n_hops + d_hops,
                           n_exp=state.n_exp + d_exp)

    round_fn = partial(expansion_round, spec, queries=queries,
                       neighbor_table=neighbor_table,
                       vector_table=vector_table, n=n,
                       nbr_fn=nbr_fn, dist_fn=dist_fn, vec_scale=vec_scale,
                       vec_codebook=vec_codebook, tombstone=tombstone)
    if iters is not None:
        for _ in range(iters):
            state = round_fn(state)
        return state
    return (yield Loop(round_fn, state, n, spec.max_iters))


def run_program(program: Program):
    """Drive a search program eagerly: each loop it yields runs through
    ``run_to_convergence``, each stage in its span (``Stage``).  Returns
    the program's result."""
    stage = None
    with contextlib.ExitStack() as span:
        try:
            item = next(program)
            while True:
                if isinstance(item, Stage):
                    span.close()
                    stage = item.name
                    span.enter_context(trace.span(stage))
                    item = program.send(None)
                else:
                    item = program.send(run_to_convergence(*item,
                                                           stage=stage))
        except StopIteration as done:
            return done.value


def pending(state: SearchState, n: int) -> torch.Tensor:
    """0-dim bool: does any query still have an unchecked candidate?"""
    return (~state.checked & (state.cand_id < n)).any()


def chunk_sizes(max_rounds: int, chunk: int):
    """The rounds of each chunk of a convergence loop: ``chunk`` at a time,
    the last one only the rounds that remain of ``max_rounds``.  Drivers
    test for work before each chunk (``run_to_convergence`` on the host's
    tensors, ``core/compiled.py`` on a captured flag)."""
    done = 0
    while done < max_rounds:
        m = min(chunk, max_rounds - done)
        yield m
        done += m


def run_to_convergence(round_fn, state: SearchState, n: int,
                       max_rounds: int, stage: Optional[str] = None
                       ) -> SearchState:
    """Apply ``round_fn`` until no query has an unchecked candidate, at most
    ``max_rounds`` times: while a host test finds work, a chunk of
    ``CHUNK`` rounds — one host sync per chunk.  Rounds past a query's
    convergence are fixed points, so the result is the one a test before
    every round gives.  Counts each test (``search.host_tests``; in a
    stage, in the span ``<stage>.test``) and each round run
    (``search.rounds``)."""
    for m in chunk_sizes(max_rounds, CHUNK):
        trace.count("search.host_tests")
        with trace.span(stage and f"{stage}.test"):
            work = bool(pending(state, n))
        if not work:
            break
        for _ in range(m):
            state = round_fn(state)
        trace.count("search.rounds", m)
    return state


def topk_from_state(state: SearchState, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    return state.cand_id[:, :k], state.cand_d[:, :k]
