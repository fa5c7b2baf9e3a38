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
    ``()`` or ``(pilot_tomb,)``."""
    arrays = _with_tombs(arrays, tombs)
    nk = arrays["pilot_to_full"].shape[0] - 1
    scale, codebook = arrays.get("primary_scale"), arrays.get("primary_codebook")
    dp = quant.primary_dim(arrays["primary"], scale, codebook=codebook)
    qp = queries[:, :dp].contiguous()
    st1 = yield from T.greedy_program(
        _pilot_spec(params), qp, arrays["sub_neighbors"], arrays["primary"],
        nk, fes_entries(arrays, params, qp), vec_scale=scale,
        vec_codebook=codebook, tombstone=arrays.get("pilot_tombstone"))
    return st1.cand_id, st1.cand_d, st1.visited


def cpu_program(arrays: Dict[str, torch.Tensor], params: SearchParams,
                queries: torch.Tensor, cand_id: torch.Tensor,
                cand_dp: torch.Tensor, visited: torch.Tensor,
                *tombs: torch.Tensor) -> T.Program:
    """Stages ② and ③ from a pilot boundary: ``(ids, dists)``.  ``tombs``:
    ``()`` or ``(pilot_tomb, tomb)``."""
    arrays = _with_tombs(arrays, tombs)
    n = arrays["rot_vecs"].shape[0] - 1
    seed_id, seed_d, _ = refine_stage(arrays, params, queries, cand_id,
                                      cand_dp, visited=visited)
    st3 = yield from T.greedy_program(
        final_spec(params), queries, arrays["full_neighbors"],
        arrays["rot_vecs"], n,
        entry_ids=torch.full((queries.shape[0], 1), n, dtype=torch.int32,
                             device=queries.device),
        extra_id=seed_id, extra_d=seed_d, tombstone=arrays.get("tombstone"))
    return T.topk_from_state(st3, params.k)


def is_consumed(t: torch.Tensor) -> bool:
    """Whether a donated stage boundary tensor was consumed by
    ``cpu_stages`` (the counterpart of ``jax.Array.is_deleted``)."""
    return getattr(t, "_consumed", False)


def _tombs(tombs, want: int) -> list:
    """The trailing bitmaps of a stage call: none, or exactly ``want``
    1-D bool tensors."""
    if len(tombs) not in (0, want):
        raise TypeError(f"expected 0 or {want} trailing tombstone bitmaps, "
                        f"got {len(tombs)}")
    for t in tombs:
        if t.dtype != torch.bool or t.dim() != 1:
            raise ValueError(f"a tombstone bitmap is a 1-D bool tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    return list(tombs)


def _pad(x: torch.Tensor, rows: int, value) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_full((rows - x.shape[0],) + x.shape[1:],
                                    value)])


class _Stages:
    """The stage pair, each stage compiled per bucket:
    ``pilot(queries) -> (cand_id, cand_d, visited)`` and
    ``cpu(queries, cand_id, cand_d, visited) -> (ids, dists)``."""

    def __init__(self, arrays: Dict[str, torch.Tensor], params: SearchParams):
        self.arrays, self.params = dict(arrays), params
        self.nk = arrays["pilot_to_full"].shape[0] - 1
        self._fns: Dict[Tuple[str, int], object] = {}

    def _call(self, program, inputs, fills, tombs) -> List[torch.Tensor]:
        """``program`` on ``inputs`` padded to their bucket (rows of
        ``fills``) and the bitmaps ``tombs``, compiled at first use;
        outputs sliced back, as views of what the next call overwrites on
        the card."""
        B = inputs[0].shape[0]
        rows = bucket_size(B)
        inputs = [_pad(x, rows, v) for x, v in zip(inputs, fills)]
        inputs += tombs
        key = (program.__name__, rows, len(tombs))
        if key not in self._fns:
            self._fns[key] = compiled.compile_program(
                partial(program, self.arrays, self.params), inputs)
        return [t[:B] for t in self._fns[key](*inputs)]

    def pilot(self, queries: torch.Tensor, *tombs: torch.Tensor):
        return tuple(t.clone() for t in self._call(
            pilot_program, [queries], [0.0], _tombs(tombs, 1)))

    def cpu(self, queries: torch.Tensor, cand_id: torch.Tensor,
            cand_dp: torch.Tensor, visited: torch.Tensor,
            *tombs: torch.Tensor):
        ids, dists = self._call(cpu_program,
                                [queries, cand_id, cand_dp, visited],
                                [0.0, self.nk, INF, False], _tombs(tombs, 2))
        return ids.clone(), dists.clone()


class _DonatedStages(_Stages):
    """The donated variant (module docstring): the same interface and
    results, the boundary use-once and the visited storage pooled."""

    def __init__(self, arrays: Dict[str, torch.Tensor], params: SearchParams):
        super().__init__(arrays, params)
        self._pool: Dict[int, List[torch.Tensor]] = {}
        self._kernel = (params.use_pallas_traversal or
                        params.use_persistent_traversal)

    def pilot(self, queries: torch.Tensor, *tombs: torch.Tensor):
        Bq = queries.shape[0]
        if self._kernel and Bq % 8 != 0:
            raise ValueError(
                f"donated split_stages needs sublane-aligned batches (a "
                f"multiple of 8, as every rung of the bucket ladder is) with "
                f"the kernel stage-① paths (got B={Bq}); pad with "
                f"multistage.pad_to_bucket first")
        cand_id, cand_d, visited = self._call(pilot_program, [queries], [0.0],
                                              _tombs(tombs, 1))
        pool = self._pool.get(Bq)
        buf = pool.pop() if pool else visited_buffer(self.params, Bq,
                                                     self.nk, queries.device)
        buf.copy_(visited)
        return cand_id.clone(), cand_d.clone(), buf

    def cpu(self, queries: torch.Tensor, cand_id: torch.Tensor,
            cand_dp: torch.Tensor, visited: torch.Tensor,
            *tombs: torch.Tensor):
        boundary = (cand_id, cand_dp, visited)
        if any(is_consumed(t) for t in boundary):
            raise RuntimeError("this stage boundary was donated to an "
                               "earlier cpu_stages call and is consumed")
        out = super().cpu(queries, *boundary, *tombs)
        for t in boundary:
            t._consumed = True
        # the storage goes back to the pool as a new tensor object (the
        # caller's, marked consumed, keeps pointing at it)
        self._pool.setdefault(queries.shape[0], []).append(visited.detach())
        return out


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
    carry no masking.  ``shard_ctx`` (the pod-sharded stage pair) needs
    ``core/distributed.py``, ROADMAP Queue A item 5, and raises until
    then."""
    if shard_ctx is not None:
        raise NotImplementedError(
            "sharded split_stages (shard_ctx) needs core/distributed.py, "
            "not ported yet: ROADMAP Queue A item 5")
    stages = (_DonatedStages if donate else _Stages)(arrays, params)
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
