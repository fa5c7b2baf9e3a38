"""Stage-level software pipelining of query batches (paper: "CPU–GPU
pipelining", Table 5 first ablation row) — port of ``repro.core.pipeline``.

The search splits at the stage-①/② boundary into two programs
(``pilot_program``: FES and stage ①; ``cpu_program``: stages ② and ③ and
the top-k), each compiled per bucket of the batch ladder by
``core/compiled.py`` — CUDA graphs on the card, plain callables on the CPU.
``pipelined_search`` keeps up to ``depth`` batches in flight: on the card
the pilot programs of later batches replay on one CUDA stream while the
oldest batch's CPU-stage program replays on another, ordered by CUDA
events (the JAX reference gets the same overlap from async dispatch).
Both stage programs run on the index's device, as the reference runs both
on one backend.

The stage boundary carries the pilot beam (compact pilot ids + stage-①
distances) and the visited filter (stages ① and ② share the compact id
space); ``multistage.refine_stage`` then re-scores exactly and hands stage
③ the beam alone, exactly as ``multistage.multistage_search`` does, so the
results are ``search``'s bit for bit.

**Donation** (``donate=True``): the boundary is use-once.  ``cpu_stages``
marks the three tensors it is given consumed (``is_consumed``; a second
use raises ``RuntimeError``, the counterpart of the reference's deleted
donated arrays) and returns the visited filter's storage — by far the
largest boundary buffer, ``(B, bloom_bits)`` per batch — to a pool per
batch size, from which the next ``pilot_stage`` of that size takes it.
Steady state allocates no new visited storage.  A captured graph writes its
outputs to fixed buffers that its next replay overwrites, while at depth D
up to D boundaries are in flight; so ``pilot_stage`` copies the graph's
outputs out into the boundary (the visited filter into the pooled buffer)
rather than keeping D sets of graph outputs: one graph per bucket, and a
copy of ~2 MB a batch at B 128.

**Deletions** (a mutable index, ``core/segments.py``): as in the reference,
the bitmaps are trailing arguments — ``pilot_stage(queries, pilot_tomb)``
and ``cpu_stages(queries, *boundary, pilot_tomb, tomb)`` — read at each
call, so a delete reaches the compiled stages without a new capture.  On
the card they are inputs of the graphs like the queries, copied into the
graph's own buffers at each call on the stage's stream.  Omitted, the
stages compile programs with no masking at all (the reference's immutable
traces); bitmap keys of ``arrays`` are not read by the stages.

Ragged batches pad to their bucket inside both stages and slice back, so
callers always see their own batch size.  The donated path keeps the
reference's contract that batches on the kernel stage-① paths are
sublane-aligned (multiples of 8, as every rung of the ladder is).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bloom as BL
from repro_torch.core import compiled, quant
from repro_torch.core import traversal as T
from repro_torch.core.multistage import (SearchParams, bucket_size,
                                         fes_entries, final_spec,
                                         refine_stage)
from repro_torch.core.multistage import pilot_spec as _pilot_spec
from repro_torch.runtime import trace

INF = float("inf")
TOMB_KEYS = ("pilot_tombstone", "tombstone")   # a mutable index's bitmaps


def visited_buffer(params: SearchParams, batch: int, nk: int,
                   device=None) -> torch.Tensor:
    """A cleared stage-① visited filter of the shape ``pilot_stage``
    produces: ``(batch, bloom_bits)`` bool for bloom mode, ``(batch, nk+1)``
    for the exact bitmap.  The donated path's pool buffers come from
    here."""
    if params.visited_mode == "bloom":
        return BL.bloom_init(batch, params.bloom_bits, device=device)
    return BL.exact_init(batch, nk, device=device)


def _with_tombs(arrays: Dict[str, torch.Tensor], tombs) -> Dict:
    """``arrays`` with the bitmaps a stage was called with (none: no
    masking), whatever bitmap keys ``arrays`` holds."""
    arrays = {k: v for k, v in arrays.items() if k not in TOMB_KEYS}
    arrays.update(zip(TOMB_KEYS, tombs))
    return arrays


def pilot_program(arrays: Dict[str, torch.Tensor], params: SearchParams,
                  queries: torch.Tensor, *tombs: torch.Tensor) -> T.Program:
    """FES and stage ① (on the card K3–K5 through ``ops.fes_select``, then
    K1 or K2): ``(cand_id, cand_d, visited)``, the pilot beam in compact
    ids with its stage-① distances and the visited filter.  ``tombs``:
    ``()`` or ``(pilot_tomb,)``.  Marks ``stage0`` and ``stage1``."""
    yield T.Stage("stage0")
    arrays = _with_tombs(arrays, tombs)
    nk = arrays["pilot_to_full"].shape[0] - 1
    scale, codebook = arrays.get("primary_scale"), arrays.get("primary_codebook")
    dp = quant.primary_dim(arrays["primary"], scale, codebook=codebook)
    qp = queries[:, :dp].contiguous()
    entries = fes_entries(arrays, params, qp)
    yield T.Stage("stage1")
    st1 = yield from T.greedy_program(
        _pilot_spec(params), qp, arrays["sub_neighbors"], arrays["primary"],
        nk, entries, vec_scale=scale, vec_codebook=codebook,
        tombstone=arrays.get("pilot_tombstone"))
    return st1.cand_id, st1.cand_d, st1.visited


def cpu_program(arrays: Dict[str, torch.Tensor], params: SearchParams,
                queries: torch.Tensor, cand_id: torch.Tensor,
                cand_dp: torch.Tensor, visited: torch.Tensor,
                *tombs: torch.Tensor, hooks=None) -> T.Program:
    """Stages ② and ③ from a pilot boundary: ``(ids, dists)``.  ``tombs``:
    ``()`` or ``(pilot_tomb, tomb)``.  Marks ``stage2`` and ``stage3``
    (which holds the top-k).

    ``hooks`` (a ``distributed.ShardHooks``: the pod-sharded stage pair)
    scores the cold rows through the shards that own them: ``dist_full`` /
    ``dist_res`` replace ``refine_stage``'s gathers from ``rot_vecs`` /
    ``residual``, and stage ③ reads its neighbour rows through ``nbr`` and
    scores them through ``dist_full``.  The hooks answer for their own rows,
    so stage ③ sentinel-masks the rows ``nbr`` returns (value-wise, which
    equals gathering from the masked table).  ``arrays``' cold keys are then
    read only at the sentinel entries, which are masked."""
    yield T.Stage("stage2")
    arrays = _with_tombs(arrays, tombs)
    tomb = arrays.get("tombstone")
    if hooks is None:
        n = arrays["rot_vecs"].shape[0] - 1
        dist_full = dist_res = nbr3 = None
    else:
        n = hooks.n
        dist_full, dist_res = hooks.dist_full, hooks.dist_res
        nbr3 = hooks.nbr if tomb is None else (
            lambda u: T.sentinel_mask(tomb, hooks.nbr(u), n))
    seed_id, seed_d, _ = refine_stage(arrays, params, queries, cand_id,
                                      cand_dp, visited=visited,
                                      dist_full_fn=dist_full,
                                      dist_res_fn=dist_res)
    yield T.Stage("stage3")
    st3 = yield from T.greedy_program(
        final_spec(params), queries, arrays["full_neighbors"],
        arrays["rot_vecs"], n,
        entry_ids=torch.full((queries.shape[0], 1), n, dtype=torch.int32,
                             device=queries.device),
        extra_id=seed_id, extra_d=seed_d, nbr_fn=nbr3, dist_fn=dist_full,
        tombstone=tomb)
    return T.topk_from_state(st3, params.k)


def is_consumed(t: torch.Tensor) -> bool:
    """Whether a donated stage boundary tensor was consumed by
    ``cpu_stages`` (the counterpart of ``jax.Array.is_deleted``)."""
    return getattr(t, "_consumed", False)


def _pad(x: torch.Tensor, rows: int, value) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_full((rows - x.shape[0],) + x.shape[1:],
                                    value)])


class _Stages:
    """The stage pair, each stage compiled per bucket:
    ``pilot(queries) -> (cand_id, cand_d, visited)`` and
    ``cpu(queries, cand_id, cand_d, visited) -> (ids, dists)``.

    ``donate=True`` (module docstring): the same interface and results,
    the boundary use-once and the visited storage pooled per batch size."""

    #: the trailing bitmaps may be left out (the immutable programs)
    tombs_optional = True

    def __init__(self, arrays: Dict[str, torch.Tensor], params: SearchParams,
                 *, donate: bool = False):
        self.arrays, self.params, self.donate = dict(arrays), params, donate
        self.nk = arrays["pilot_to_full"].shape[0] - 1
        self._fns: Dict[tuple, object] = {}
        self._pool: Dict[int, List[torch.Tensor]] = {}
        self._kernel = (params.use_pallas_traversal or
                        params.use_persistent_traversal)
        self.eager = False          # compile_program's choice by device

    def _tombs(self, tombs, want: int) -> list:
        """The trailing bitmaps of a stage call: ``want`` 1-D bool tensors
        (or none, where the stages may run unmasked)."""
        if len(tombs) != want and not (self.tombs_optional and not tombs):
            raise TypeError(
                f"expected {'0 or ' if self.tombs_optional else ''}{want} "
                f"trailing tombstone bitmaps, got {len(tombs)}")
        for t in tombs:
            if t.dtype != torch.bool or t.dim() != 1:
                raise ValueError(f"a tombstone bitmap is a 1-D bool tensor, "
                                 f"got {tuple(t.shape)} {t.dtype}")
        return list(tombs)

    def _call(self, program, inputs, fills, tombs, arrays=None
              ) -> List[torch.Tensor]:
        """``program`` over ``arrays`` (default: the pair's) on ``inputs``
        padded to their bucket (rows of ``fills``) and the bitmaps
        ``tombs``, compiled at first use per (program, bucket, bitmaps,
        device); outputs sliced back, as views of what the next call of
        that program overwrites on the card."""
        B = inputs[0].shape[0]
        rows = bucket_size(B)
        inputs = [_pad(x, rows, v) for x, v in zip(inputs, fills)]
        inputs += tombs
        key = (program, rows, len(tombs), inputs[0].device)
        if key not in self._fns:
            fn = partial(program, self.arrays if arrays is None else arrays,
                         self.params)
            self._fns[key] = (compiled.EagerProgram(fn) if self.eager
                              else compiled.compile_program(fn, inputs))
        return [t[:B] for t in self._fns[key](*inputs)]

    def _pilot(self, queries, tombs) -> List[torch.Tensor]:
        return self._call(pilot_program, [queries], [0.0], tombs)

    def _cpu(self, queries, boundary, tombs) -> List[torch.Tensor]:
        return self._call(cpu_program, [queries, *boundary],
                          [0.0, self.nk, INF, False], tombs)

    def pilot(self, queries: torch.Tensor, *tombs: torch.Tensor):
        tombs = self._tombs(tombs, 1)
        Bq = queries.shape[0]
        if self.donate and self._kernel and Bq % 8 != 0:
            raise ValueError(
                f"donated split_stages needs sublane-aligned batches (a "
                f"multiple of 8, as every rung of the bucket ladder is) with "
                f"the kernel stage-① paths (got B={Bq}); pad with "
                f"multistage.pad_to_bucket first")
        cand_id, cand_d, visited = self._pilot(queries, tombs)
        if not self.donate:
            return cand_id.clone(), cand_d.clone(), visited.clone()
        pool = self._pool.get(Bq)
        buf = pool.pop() if pool else visited_buffer(self.params, Bq,
                                                     self.nk, queries.device)
        buf.copy_(visited)
        return cand_id.clone(), cand_d.clone(), buf

    def cpu(self, queries: torch.Tensor, cand_id: torch.Tensor,
            cand_dp: torch.Tensor, visited: torch.Tensor,
            *tombs: torch.Tensor):
        tombs = self._tombs(tombs, 2)
        boundary = (cand_id, cand_dp, visited)
        if self.donate and any(is_consumed(t) for t in boundary):
            raise RuntimeError("this stage boundary was donated to an "
                               "earlier cpu_stages call and is consumed")
        ids, dists = self._cpu(queries, boundary, tombs)
        out = ids.clone(), dists.clone()
        if self.donate:
            for t in boundary:
                t._consumed = True
            # the storage goes back to the pool as a new tensor object (the
            # caller's, marked consumed, keeps pointing at it)
            self._pool.setdefault(queries.shape[0], []).append(
                visited.detach())
        return out


class _ShardedStages(_Stages):
    """The pod-sharded stage pair: the same ``pilot(queries, pilot_tomb)``
    / ``cpu(queries, cand_id, cand_d, visited, pilot_tomb, tomb)``
    interface, over ``shards`` (each key a tuple of per-shard tensors, in
    ``shard_ctx``'s device order, as ``distributed.ShardedSegmentedIndex``
    lays them out).  The bitmaps are REQUIRED trailing arguments (a sharded
    serving index is mutable by construction).  One controller runs every
    shard's part, each on its shard's device.

    Placement (``shard_ctx.placement``):
      * ``hot-replicated`` — the hot tables are replicated, the cold ones
        (``distributed.COLD_KEYS``) row-sharded.  Stage 0 and stage ① are
        replicated data and replicated compute, so they run once a batch on
        the primary device (shard 0's; on the card K3–K5 and K1 or K2, as
        in the unsharded pair): their results are what every shard would
        compute.  Stages ②③ score the cold rows through
        ``distributed.shard_local_dist_fn`` / ``shard_local_nbr_fn``: each
        shard answers from its own slice, and the owner's value is
        selected (bit-exact, ``distributed.owner_select``).
      * ``replicated`` — every table replicated, the query batch split into
        ``n_shards`` equal slices, one per shard device (the batch must
        divide by the shard count; the bucket ladder's multiples-of-8 rungs
        do for <= 8 shards).  Each slice runs the unsharded programs at its
        own row count, which on the card may move distance bits (another
        bucket), never ids.

    The true corpus size is ``shard_ctx.n``: the cold tables are row-padded
    to ``n_shards * rows_per``.  Compilation: a layout whose shards all
    live on the primary device (the queries' device) compiles each program
    per bucket with ``compiled.compile_program`` — CUDA graphs on the card,
    the hooks recorded with the rest, as they keep static shapes.  A layout
    that spans several devices runs the same programs eagerly
    (``compiled.EagerProgram``).  The layout makes that choice here, once.
    Donation: as ``_Stages``."""

    tombs_optional = False

    def __init__(self, shards: Dict[str, tuple], params: SearchParams,
                 ctx, *, donate: bool = False):
        from repro_torch.core import distributed as DI

        self.ctx = ctx
        self.devices = list(ctx.mesh.devices.ravel())
        primary = self.devices[0]
        self.hot_repl = ctx.placement == "hot-replicated"
        # replica (or shard slice) s of every table, in shard order
        self.replicas = [{k: v[s] for k, v in shards.items()}
                         for s in range(ctx.n_shards)]
        arrays = dict(self.replicas[0])
        self.hooks = None
        if self.hot_repl:
            self.hooks = DI.ShardHooks(
                n=ctx.n,
                nbr=DI.shard_local_nbr_fn(shards["full_neighbors"],
                                          ctx.rows_per),
                dist_full=DI.shard_local_dist_fn(shards["rot_vecs"],
                                                 ctx.rows_per),
                dist_res=DI.shard_local_dist_fn(shards["residual"],
                                                ctx.rows_per))
            # the cold keys' stand-ins: the sentinel row broadcast to the
            # table's shape (read only at masked sentinel entries)
            for key in DI.COLD_KEYS:
                row = shards[key][0][-1:]
                fill = ctx.n if key == "full_neighbors" else 0
                arrays[key] = torch.full_like(row, fill).to(primary).expand(
                    ctx.n + 1, row.shape[1])
            self._cpu_program = partial(cpu_program, hooks=self.hooks)
        super().__init__(arrays, params, donate=donate)
        self.eager = any(d != primary for d in self.devices)

    def _check_batch(self, Bq: int) -> None:
        if not self.hot_repl and Bq % self.ctx.n_shards != 0:
            raise ValueError(
                f"'replicated' placement shards the query batch: B={Bq} "
                f"must divide by n_shards={self.ctx.n_shards} (bucket-pad "
                f"with multistage.pad_to_bucket first)")

    def _per_shard(self, program, inputs, fills, tombs):
        """``replicated``: shard s runs ``program`` on slice s of every
        input, on its device over its replica; the slices' outputs are
        joined on the primary device."""
        m = inputs[0].shape[0] // self.ctx.n_shards
        outs = []
        for s, dev in enumerate(self.devices):
            part = [x[s * m:(s + 1) * m].to(dev) for x in inputs]
            got = self._call(program, part, fills, [t.to(dev) for t in tombs],
                             arrays=self.replicas[s])
            # a copy before the next shard's call overwrites the outputs
            outs.append([t.clone().to(self.devices[0]) for t in got])
        return [torch.cat(parts) for parts in zip(*outs)]

    def _pilot(self, queries, tombs):
        self._check_batch(queries.shape[0])
        if self.hot_repl:
            return super()._pilot(queries, tombs)
        return self._per_shard(pilot_program, [queries], [0.0], tombs)

    def _cpu(self, queries, boundary, tombs):
        self._check_batch(queries.shape[0])
        fills = [0.0, self.nk, INF, False]
        if self.hot_repl:
            return self._call(self._cpu_program, [queries, *boundary], fills,
                              tombs)
        return self._per_shard(cpu_program, [queries, *boundary], fills,
                               tombs)


def split_stages(arrays: Dict[str, torch.Tensor], params: SearchParams,
                 *, donate: bool = False, shard_ctx=None):
    """The pilot stage (FES + ①) and the CPU stages (②③ + top-k), each
    compiled separately so they can be dispatched independently (the
    pipelining boundary).  Returns ``(pilot_stage, cpu_stages)`` with
    ``pilot_stage(queries[, pilot_tomb]) -> (cand_id, cand_d, visited)``
    and ``cpu_stages(queries, cand_id, cand_d, visited[, pilot_tomb, tomb])
    -> (ids, dists)``, on the device of the queries (the index's).

    donate=True swaps in the donated variant (module docstring): consuming
    the boundary in ``cpu_stages`` invalidates it, and the visited filter's
    storage is recycled into the next ``pilot_stage`` of the same batch
    size.  The interface and the results are identical either way.

    The deletion bitmaps of a mutable index (``core/segments.py``) are the
    optional trailing arguments, as in the reference: given, they are read
    at every call (a delete needs no new capture); omitted, the programs
    carry no masking.

    ``shard_ctx`` (a ``distributed.ShardContext``) selects the pod-sharded
    pair (``_ShardedStages``) over ``arrays`` laid out per shard (each key
    a tuple of per-shard tensors, ``ShardedSegmentedIndex._shard_arrays``):
    results bit-identical to the unsharded pair at every shard count (the
    ``replicated`` placement: ids, distances within the fp32 bound on the
    card), and the bitmaps become REQUIRED trailing arguments."""
    if shard_ctx is not None:
        stages = _ShardedStages(arrays, params, shard_ctx, donate=donate)
    else:
        stages = _Stages(arrays, params, donate=donate)
    return stages.pilot, stages.cpu


def degrade_params(params: SearchParams, scale: float = 0.5) -> SearchParams:
    """The low-cost rung of the serving degradation ladder: the same
    pipeline at a ``scale``-reduced beam/frontier budget.

    Shrinks the recall/latency dials — ``ef``, ``ef_pilot``, ``fes_L`` —
    while keeping everything that defines the *result contract* (``k``,
    visited structure, kernel selection) identical, so the degraded stage
    pair is just another entry of the bucketed compiled-call cache."""
    if not 0.0 < scale <= 1.0:
        raise ValueError(f"scale must be in (0, 1], got {scale}")
    return dataclasses.replace(
        params,
        ef=max(params.k, int(params.ef * scale)),
        ef_pilot=max(params.k, int(params.ef_pilot * scale)),
        fes_L=max(4, int(params.fes_L * scale)))


def pipelined_search(arrays: Dict[str, torch.Tensor], params: SearchParams,
                     query_batches: List[torch.Tensor],
                     *, pipelined: bool = True, depth: int = 2,
                     donate: bool = False,
                     record_into: Optional[List[Dict]] = None
                     ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], float]:
    """Run a stream of (rotated) query batches; returns (results,
    wall_seconds).

    depth: maximum batches in flight — the pilot stages of up to ``depth``
    batches are dispatched while the oldest batch's CPU stages drain
    (depth=2 reproduces the classic two-deep overlap).  With
    pipelined=False the stages of each batch run strictly in sequence — the
    "- pipelining" ablation.  donate: recycle the stage-boundary buffers
    (see ``split_stages``; requires sublane-aligned batches on the kernel
    paths).  record_into: optional list; one dict per batch with per-stage
    wall-clock timestamps (``t_pilot_dispatch`` / ``t_cpu_start`` /
    ``t_done``, seconds relative to the timed region's start) is
    appended."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    pilot_stage, cpu_stages = split_stages(arrays, params, donate=donate)
    dev = query_batches[0].device
    card = dev.type == "cuda"

    # warmup/compile outside the timed region
    cpu_stages(query_batches[0], *pilot_stage(query_batches[0]))
    if card:
        torch.cuda.synchronize(dev)
        pilot_s, cpu_s = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    on = ((lambda s: torch.cuda.stream(s)) if card
          else (lambda s: contextlib.nullcontext()))

    results: List = [None] * len(query_batches)
    t0 = time.perf_counter()
    now = lambda: time.perf_counter() - t0

    def dispatch(i, q):
        with on(pilot_s if card else None):
            po = pilot_stage(q)
            ready = torch.cuda.Event() if card else None
            if card:
                ready.record()
        return i, q, po, ready

    def drain(entry, t_disp):
        j, qj, poj, ready = entry
        t_cpu = now()
        with on(cpu_s if card else None):
            if card:
                cpu_s.wait_event(ready)
            ids, dists = cpu_stages(qj, *poj)
            with trace.span("readback"):
                results[j] = (ids.cpu().numpy(), dists.cpu().numpy())
        if record_into is not None:
            record_into.append({"batch": j, "t_pilot_dispatch": t_disp,
                                "t_cpu_start": t_cpu, "t_done": now()})

    if pipelined:
        inflight: deque = deque()     # ((idx, queries, boundary, event), t)
        for i, q in enumerate(query_batches):
            inflight.append((dispatch(i, q), now()))     # dispatched async
            if len(inflight) >= depth:
                drain(*inflight.popleft())
        while inflight:
            drain(*inflight.popleft())
    else:
        for i, q in enumerate(query_batches):
            t_disp = now()
            entry = dispatch(i, q)
            if card:
                entry[3].synchronize()
            drain(entry, t_disp)
    return results, time.perf_counter() - t0
