"""Continuous-batching throughput runtime (DESIGN.md §5, §6, §8) — port of
``repro.serving.server``.

``ThroughputEngine`` is the serving loop around the search core:

1. **Shape-bucketed stage programs** — requests drained from
   ``BatchingQueue`` are padded to a fixed ladder of batch sizes, and the
   stage pair (``pipeline.split_stages``) compiles one (pilot, cpu) program
   pair per bucket — CUDA graphs on the card, captured by ``warmup()``
   outside the serving window.
2. **Donated search state** — the stage boundary is use-once and the
   visited filter's storage is pooled (``split_stages(donate=True)``).
3. **Depth-D in-flight batches** — the pilot stages of up to ``depth``
   batches are dispatched before the oldest batch's CPU stages drain.  On
   the card the pilot stages replay on a stream of their own and the CPU
   stages on another, ordered by an event per batch, as
   ``pipeline.pipelined_search`` does; per-stage timestamps land in
   ``stats["batch_records"]``.
4. **Semantic-cache short-circuit** — with ``use_semantic_cache``, each
   submitted query is first looked up in a ``SemanticCache``; a hit
   completes the request without touching the stages, and every completed
   request is inserted (one row at a time, as in the reference).
5. **Streaming upserts** — serving a ``core/segments.SegmentedIndex``,
   ``submit_upsert`` / ``submit_delete`` enqueue mutations that are applied
   *between* pump batches (``mutations_per_pump`` rows at a time), after the
   batches in flight have drained.  The stage pair takes the base's
   deletion bitmaps as trailing arguments; the index updates them in place,
   so a delete re-captures nothing.  Inserts land in delta segments whose
   top-k is merged with each base batch at drain time; a ``compact()``
   bumps the index generation and the engine rebuilds its stage pair
   (``stats["stage_rebuilds"]``).
6. **SLO-aware resilience** — ``max_pending`` admission with priority
   shedding, hard expiry, the degraded rung (``pipeline.degrade_params``)
   taken per batch when the rolling p99 threatens ``p99_budget_s``, and
   ``RestartPolicy``-backed mutation retries (idempotent by
   ``MutationTicket.seq``); ``runtime/chaos.py`` injects faults at the
   decision points.
7. **Pod-sharded serving** — over a ``core/distributed.
   ShardedSegmentedIndex`` the stage pair is the index's sharded pair
   (``stage_pair``, the bitmaps from ``shard_tombs()``), upserts ride one
   queue per shard (round-robin, deletes routed by ``shard_of_gids``) and
   drain in global submission order, and a ``HeartbeatMonitor`` per shard
   fails a quiet shard over to the tombstone overlay
   (``set_dead_shards``) and heals it when its beats resume.

Every request ends in exactly one terminal state (``completed``,
``rejected`` or ``expired``).  Results are the stage pair's, which equal
``index.search``'s bit for bit at the same bucket.

**One clock.**  The queue (enqueue times, deadlines, expiry), the
heartbeats and the engine's own timestamps (dispatch, drain, completion,
``batch_records``) read one function: the injected ``clock`` or
``time.perf_counter``.  So a request's latency splits exactly, and at each
drain the engine adds, for every request it completes, to the counters of
``runtime/trace.py`` (integer microseconds of that clock, always on):
``engine.queued_us`` (enqueue → dispatch: the wait for a batch to form),
``engine.in_flight_us`` (dispatch → the start of its drain: the pilot stage
and the wait behind the batches ahead) and ``engine.drain_us`` (drain start
→ completion: the CPU stages, the readback and the segment merge), and 1
to ``engine.requests``.  While tracing is on, ``pump``'s work runs in the
spans ``repro_torch.engine.dispatch`` and ``.drain`` (with the batch's
sequence number, ``batch``), ``.expire`` (while requests are pending) and
``.mutations`` (while mutations are), and the copies of results to the
host in ``repro_torch.readback``.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import multistage
from repro_torch.core.multistage import SearchParams
from repro_torch.core.distributed import ShardedSegmentedIndex
from repro_torch.core.pipeline import degrade_params, split_stages
from repro_torch.core.segments import SegmentedIndex
from repro_torch.runtime.chaos import ChaosError
from repro_torch.runtime import trace
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, RestartPolicy
from repro_torch.serving.batching import BatchingQueue, Request
from repro_torch.serving.semantic_cache import SemanticCache


@dataclass(frozen=True)
class ServeParams:
    """Serving-runtime knobs (the reference's; docs/api.md)."""
    # padded batch-size ladder (ascending)
    buckets: Tuple[int, ...] = multistage.BATCH_BUCKETS
    # max batches in flight (depth=1 = no overlap)
    depth: int = 2
    # donate stage-boundary buffers into the CPU-stage program
    donate: bool = True
    # deadline for partially-filled batches (bounds p99 at low load)
    max_wait_s: float = 0.002
    # compile (capture) one (pilot, cpu) program pair per bucket at
    # construction
    warmup: bool = True
    # semantic-cache short-circuit in front of the pilot stage
    use_semantic_cache: bool = False
    cache_threshold: float = 0.05     # max squared distance for a cache hit
    cache_rebuild_every: int = 256    # cache compaction cadence (idle-cycle)
    # max mutation rows applied from the upsert queues between two batches
    mutations_per_pump: int = 64
    # -- resilience -------------------------------------------------------
    # admission control: max queued requests (None = unbounded)
    max_pending: Optional[int] = None
    # hard SLO cutoff: default request expiry = submit time + this
    slo_timeout_s: Optional[float] = None
    # degradation ladder: dispatch on the low-cost rung when the rolling
    # p99 (or head-of-line wait + typical service) threatens this budget;
    # None disables the ladder (no extra programs)
    p99_budget_s: Optional[float] = None
    degrade_ef_scale: float = 0.5
    slo_window: int = 64
    # shard liveness (sharded index only)
    heartbeat_timeout_s: float = 1.0
    # mutation fault tolerance: RestartPolicy retry budget + base backoff
    mutation_max_retries: int = 3
    mutation_backoff_s: float = 0.05


@dataclass
class MutationTicket:
    """Handle for one queued mutation: ``done`` flips when it is applied
    between pump batches (or, after the retry budget, surfaced as
    ``failed`` with ``error``); for inserts ``gids`` then carries the
    assigned global ids.  ``seq`` is the global submission order, which the
    drain preserves; ``shard`` is the upsert queue it rides (always 0 on a
    single-device index)."""
    kind: str                         # "insert" | "delete"
    payload: Any
    done: bool = False
    gids: Optional[np.ndarray] = None
    shard: int = 0
    seq: int = -1
    attempts: int = 0
    failed: bool = False
    error: Optional[str] = None


class ThroughputEngine:
    """Continuous-batching serving runtime over a ``PilotANNIndex``, a
    ``SegmentedIndex`` or a ``ShardedSegmentedIndex``.

    Either the offline driver ``serve(queries, arrival_times)`` (replays an
    arrival process, returns per-request results + serving stats) or the
    online primitives ``submit`` / ``pump`` / ``flush``.
    """

    def __init__(self, index, params: SearchParams,
                 serve_params: Optional[ServeParams] = None, *,
                 clock: Optional[Callable[[], float]] = None,
                 fault_injector=None):
        self.index = index
        # the one clock of the queue, expiry, heartbeats and the engine's
        # timestamps; an injected one (runtime.chaos.SimClock) makes that
        # timeline deterministic.  A runtime.chaos.FaultInjector is
        # consulted at the decision points
        self._clock = clock if clock is not None else time.perf_counter
        self._fault_injector = fault_injector
        self.segments: Optional[SegmentedIndex] = \
            index if isinstance(index, SegmentedIndex) else None
        # a ShardedSegmentedIndex is a SegmentedIndex, so the mutable
        # plumbing applies; the stage pair and the mutation routing
        # specialise below
        self.sharded: Optional[ShardedSegmentedIndex] = \
            index if isinstance(index, ShardedSegmentedIndex) else None
        self.params = params
        self.serve_params = serve_params or ServeParams()
        sp = self.serve_params
        if sp.depth < 1:
            raise ValueError(f"depth must be >= 1, got {sp.depth}")
        if not sp.buckets or list(sp.buckets) != sorted(sp.buckets):
            raise ValueError(f"buckets must be a non-empty ascending ladder, "
                             f"got {sp.buckets}")
        dev = index.device
        self._card = dev.type == "cuda"
        if self._card:
            self._pilot_stream = torch.cuda.Stream(dev)
            self._cpu_stream = torch.cuda.Stream(dev)
        self._generation = -1
        self._build_stages()
        self.queue = BatchingQueue(sp.buckets[-1], max_wait_s=sp.max_wait_s,
                                   clock=self._clock,
                                   max_pending=sp.max_pending)
        # shard liveness: one heartbeat per shard; a shard quiet past the
        # timeout is declared dead and the index fails over to the
        # tombstone overlay
        self.heartbeats: Optional[HeartbeatMonitor] = None
        if self.sharded is not None:
            self.heartbeats = HeartbeatMonitor(
                [f"shard:{i}" for i in range(self.sharded.sp.n_shards)],
                timeout_s=sp.heartbeat_timeout_s, clock=self._clock)
        # rolling SLO telemetry: recent completed-request latencies and
        # batch service times drive ``_should_degrade``
        self._lat_window: Deque[float] = deque(maxlen=max(8, sp.slo_window))
        self._svc_window: Deque[float] = deque(maxlen=32)
        self.cache: Optional[SemanticCache] = None
        if sp.use_semantic_cache:
            self.cache = SemanticCache(dim=index.d,
                                       threshold=sp.cache_threshold,
                                       rebuild_every=sp.cache_rebuild_every,
                                       device=dev)
        # in-flight batches: (requests, padded rotated queries, pilot
        # outputs, event after the pilot stage or None, dispatch timestamp,
        # earliest deadline, degraded rung?, sequence number)
        self._inflight: List[Tuple] = []
        # one upsert queue per shard (one on a single device); ``seq``
        # keeps the global submission order across them
        nq = self.sharded.sp.n_shards if self.sharded is not None else 1
        self._mut_queues: List[Deque[MutationTicket]] = [
            deque() for _ in range(nq)]
        self._mut_seq = 0
        self._rr_shard = 0
        self._mut_restart = [RestartPolicy(
            max_restarts=sp.mutation_max_retries,
            base_backoff_s=sp.mutation_backoff_s,
            max_backoff_s=max(sp.mutation_backoff_s, 1e-9) * 64)
            for _ in range(nq)]
        self._mut_not_before = [0.0] * nq
        self._completions: Dict[int, float] = {}      # rid -> done timestamp
        self.stats: Dict[str, Any] = {
            "requests": 0, "batches": 0, "bucket_hist": {},
            "cache_lookups": 0, "cache_hits": 0, "batch_records": [],
            "upserts": 0, "deletes": 0, "mutation_drains": 0,
            "mutation_time_s": 0.0,
            "stage_rebuilds": 0, "cache_maintenance": 0,
            "completed": 0, "rejected": 0, "expired": 0, "shed": 0,
            "degraded_batches": 0, "shard_failovers": 0, "shard_heals": 0,
            "degraded_coverage": 0.0, "mutation_retries": 0,
            "mutation_failures": 0}
        if sp.warmup:
            self.warmup()

    # -- stage pair ---------------------------------------------------------
    def _build_stages(self) -> None:
        """(Re)build the stage pair.  An immutable index's stages close over
        its arrays; a ``SegmentedIndex`` base's stages take the deletion
        bitmaps as trailing arguments, read at every call — a delete
        applies with no new capture, and only a ``compact()`` (generation
        bump, seen at dispatch and in the mutation drain) rebuilds.  A
        ``ShardedSegmentedIndex`` gives its own cached sharded pair, called
        with ``shard_tombs()`` (the dead-shard overlay while degraded)."""
        sp = self.serve_params
        self._degraded_params: Optional[SearchParams] = None
        self._pilot_lo = self._cpu_lo = None
        if sp.p99_budget_s is not None and sp.degrade_ef_scale < 1.0:
            self._degraded_params = degrade_params(self.params,
                                                   sp.degrade_ef_scale)
        self._stage_sets = []

        def stages(arrays, params):
            pair = split_stages(arrays, params, donate=sp.donate)
            self._stage_sets.append(pair[0].__self__)
            return pair
        if self.sharded is not None:
            sh = self.sharded

            def sharded(params):
                pilot, cpu = sh.stage_pair(params, donate=sp.donate)
                self._stage_sets.append(pilot.__self__)
                return (lambda q: pilot(q, sh.shard_tombs()[0]),
                        lambda q, *po: cpu(q, *po, *sh.shard_tombs()))
            self._pilot_call, self._cpu_call = sharded(self.params)
            if self._degraded_params is not None:
                self._pilot_lo, self._cpu_lo = sharded(self._degraded_params)
            self._generation = sh.generation
            return
        if self.segments is None:
            self._pilot_call, self._cpu_call = stages(self.index.arrays,
                                                      self.params)
            if self._degraded_params is not None:
                self._pilot_lo, self._cpu_lo = stages(
                    self.index.arrays, self._degraded_params)
            return
        base = self.segments.base

        def with_tombs(pilot, cpu):
            A = base.arrays
            return (lambda q: pilot(q, A["pilot_tombstone"]),
                    lambda q, *po: cpu(q, *po, A["pilot_tombstone"],
                                       A["tombstone"]))
        self._pilot_call, self._cpu_call = with_tombs(*stages(
            base.arrays, self.params))
        if self._degraded_params is not None:
            self._pilot_lo, self._cpu_lo = with_tombs(*stages(
                base.arrays, self._degraded_params))
        self._generation = self.segments.generation

    def compile_count(self) -> int:
        """Compiled stage programs held (pilot and CPU stage, per bucket,
        both rungs): on the card, the captured CUDA graphs.  A delete
        leaves it unchanged; a stage rebuild starts it over."""
        return sum(len(s._fns) for s in self._stage_sets)

    # -- clock ------------------------------------------------------------
    def _now(self) -> float:
        return self._clock()

    def _on(self, stream):
        return torch.cuda.stream(stream) if self._card \
            else contextlib.nullcontext()

    # -- precompile -------------------------------------------------------
    def warmup(self) -> int:
        """Compile (on the card: capture) one (pilot, cpu) program pair per
        bucket on zero queries, the degraded rung's too; returns the number
        of buckets warmed.  Over a ``SegmentedIndex`` also runs its
        mutation/merge path once (``SegmentedIndex.warmup``)."""
        for b in self.serve_params.buckets:
            q = torch.zeros((b, self.index.d), dtype=torch.float32,
                            device=self.index.device)
            self._cpu_call(q, *self._pilot_call(q))
            if self._pilot_lo is not None:
                self._cpu_lo(q, *self._pilot_lo(q))
        if self._card:
            torch.cuda.synchronize(self.index.device)
        if self.segments is not None:
            self.segments.warmup(self.params, self.serve_params.buckets)
            if self._degraded_params is not None:
                self.segments.warmup(self._degraded_params,
                                     self.serve_params.buckets)
        return len(self.serve_params.buckets)

    # -- mutation entry ------------------------------------------------------
    def _mutations_pending(self) -> bool:
        return any(self._mut_queues)

    def _mutation_span(self) -> Optional[str]:
        return "engine.mutations" if self._mutations_pending() else None

    def submit_upsert(self, vectors: np.ndarray,
                      shard: Optional[int] = None) -> MutationTicket:
        """Queue vectors for insertion into the segmented index, applied
        between pump batches (``mutations_per_pump`` rows at a time); the
        ticket's ``gids`` fills in when it lands.  On a sharded index the
        batch rides the upsert queue of ``shard`` (round-robin when None)
        and lands in that shard's delta segment."""
        if self.segments is None:
            raise ValueError("streaming upserts need a SegmentedIndex "
                             "(core/segments.py); this engine serves an "
                             "immutable PilotANNIndex")
        nq = len(self._mut_queues)
        if shard is not None and not 0 <= shard < nq:
            raise ValueError(f"shard {shard} out of range [0, {nq})")
        if shard is None:
            shard = self._rr_shard
            self._rr_shard = (self._rr_shard + 1) % nq
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        t = MutationTicket("insert", vectors, shard=shard, seq=self._mut_seq)
        self._mut_seq += 1
        self._mut_queues[shard].append(t)
        return t

    def submit_delete(self, gids) -> MutationTicket:
        """Queue global ids for tombstoning (applied between pump batches).
        On a sharded index the ticket rides the queue of the shard that
        owns the first id (the bitmaps are the index's: routing only
        spreads the drain work)."""
        if self.segments is None:
            raise ValueError("streaming deletes need a SegmentedIndex")
        payload = np.atleast_1d(np.asarray(gids, np.int64))
        shard = 0
        if self.sharded is not None and len(payload):
            shard = int(self.sharded.shard_of_gids(payload[:1])[0])
        t = MutationTicket("delete", payload, shard=shard, seq=self._mut_seq)
        self._mut_seq += 1
        self._mut_queues[shard].append(t)
        return t

    def _mut_eligible(self, *, ignore_backoff: bool) -> List[int]:
        """Queues with work whose retry backoff (if any) has elapsed."""
        now = self.queue.clock()
        return [i for i, q in enumerate(self._mut_queues)
                if q and (ignore_backoff or now >= self._mut_not_before[i])]

    def _apply_mutations(self, max_rows: int, *,
                         ignore_backoff: bool = False) -> bool:
        """Drain up to ``max_rows`` mutation rows in submission order —
        called between pump batches, after the batches in flight have
        drained (a mutation may compact the index, which would invalidate
        their positional ids).  A run of same-kind tickets with consecutive
        ``seq`` coalesces into one index call.  A drain that raises
        re-queues its run at the head (same seq; done tickets are never
        re-applied) and arms ``RestartPolicy`` backoff; when the policy
        gives up the tickets end ``failed``.  Rebuilds the stage pair on a
        generation bump.  Returns False when nothing was attempted."""
        if self.segments is None or max_rows <= 0 \
                or not self._mut_eligible(ignore_backoff=ignore_backoff):
            return False
        while self._inflight:
            self._drain_oldest()
        rows = 0
        while rows < max_rows:
            eligible = self._mut_eligible(ignore_backoff=ignore_backoff)
            if not eligible:
                break
            qi = min(eligible, key=lambda i: self._mut_queues[i][0].seq)
            mq = self._mut_queues[qi]
            run = [mq.popleft()]
            while (mq and mq[0].kind == run[0].kind
                   and mq[0].seq == run[-1].seq + 1
                   and rows + sum(len(t.payload) for t in run)
                   + len(mq[0].payload) <= max_rows):
                run.append(mq.popleft())
            payload = np.concatenate([t.payload for t in run])
            try:
                for t in run:
                    t.attempts += 1
                if self._fault_injector is not None \
                        and self._fault_injector.mutation_should_fail():
                    raise ChaosError("injected mutation failure")
                mt0 = time.perf_counter()
                if run[0].kind == "insert":
                    gids = (self.sharded.insert(payload, shard=qi)
                            if self.sharded is not None
                            else self.segments.insert(payload))
                    self.stats["upserts"] += len(gids)
                    rows += len(gids)
                    off = 0
                    for t in run:
                        t.gids = gids[off:off + len(t.payload)]
                        off += len(t.payload)
                else:
                    self.stats["deletes"] += self.segments.delete(payload)
                    rows += len(payload)
                # repair wall-clock, apart from search time
                self.stats["mutation_time_s"] += time.perf_counter() - mt0
            except Exception as exc:
                # a drain must keep running: the failure is surfaced on the
                # tickets (retried, or ``failed`` with the error) and never
                # dropped
                pol = self._mut_restart[qi]
                backoff = pol.next_backoff()
                if backoff is None:
                    for t in run:
                        t.failed = True
                        t.error = f"{type(exc).__name__}: {exc}"
                        t.done = True
                    self.stats["mutation_failures"] += len(run)
                    pol.restarts = 0
                else:
                    self.stats["mutation_retries"] += 1
                    for t in reversed(run):
                        mq.appendleft(t)
                    self._mut_not_before[qi] = self.queue.clock() + backoff
                continue
            self._mut_restart[qi].restarts = 0
            for t in run:
                t.done = True
        self.stats["mutation_drains"] += 1
        if self.segments.generation != self._generation:
            self._build_stages()
            self.stats["stage_rebuilds"] += 1
        return True

    def flush_mutations(self) -> None:
        """Apply every queued mutation now, retrying failing runs at once
        (backoff is a between-batches courtesy); tickets whose policy gives
        up come back ``failed``."""
        while self._mutations_pending():
            if not self._apply_mutations(1 << 30, ignore_backoff=True):
                break

    # -- request entry ----------------------------------------------------
    def _sync_queue_counters(self) -> None:
        c = self.queue.counters
        self.stats["rejected"] = c["rejected"]
        self.stats["expired"] = c["expired"]
        self.stats["shed"] = c["shed"]

    def submit(self, query: np.ndarray, *, priority: int = 0,
               expiry: Optional[float] = None) -> Request:
        """Enqueue one raw (un-rotated) query.  With the semantic cache on,
        a hit completes the request at once.  The request may come back
        already ``rejected`` (admission control); ``expiry`` (absolute,
        queue clock) defaults to now + ``slo_timeout_s`` when that is
        set."""
        q = np.asarray(query, np.float32)
        self.stats["requests"] += 1
        sp = self.serve_params
        if expiry is None and sp.slo_timeout_s is not None:
            expiry = self.queue.clock() + sp.slo_timeout_s
        req = self.queue.submit(q, expiry=expiry, priority=priority)
        self._sync_queue_counters()
        if req.terminal:
            return req
        if self.cache is not None:
            self.stats["cache_lookups"] += 1
            hit = self.cache.lookup(q)
            if hit is not None:
                self.stats["cache_hits"] += 1
                self.queue.pending.remove(req)
                req.complete(hit)
                self.stats["completed"] += 1
                self._completions[req.rid] = self._now()
        return req

    # -- SLO hooks --------------------------------------------------------
    def _should_degrade(self) -> bool:
        """True when the next batch should take the low-cost rung: the
        rolling p99 already threatens the budget, or the head-of-line
        request's wait plus a typical service time would."""
        sp = self.serve_params
        if self._pilot_lo is None:
            return False
        budget = sp.p99_budget_s
        lat = sorted(self._lat_window)
        if len(lat) >= 8 and lat[int(0.99 * (len(lat) - 1))] > budget:
            return True
        if self.queue.pending and self._svc_window:
            head_wait = self.queue.clock() - self.queue.pending[0].enqueued_at
            svc = sorted(self._svc_window)[len(self._svc_window) // 2]
            if head_wait + svc > budget:
                return True
        return False

    def _check_shard_health(self) -> None:
        """Heartbeats and the failover/heal transitions.  In-process shards
        beat on every pump unless a fault injector holds a stall or loss
        window for them; a shard quiet past the timeout is declared dead
        and the sharded index enters its overlay mode (the exposure in
        ``stats["degraded_coverage"]``); when the beats resume the overlay
        goes and results return to bit-parity with the healthy index."""
        if self.heartbeats is None:
            return
        inj = self._fault_injector
        stalled = inj.stalled_shards() if inj is not None else set()
        for i in range(self.sharded.sp.n_shards):
            if i not in stalled:
                self.heartbeats.beat(f"shard:{i}")
        dead = {int(h.split(":")[1]) for h in self.heartbeats.dead_hosts()}
        if dead == set(self.sharded.dead_shards):
            return
        self.stats["degraded_coverage"] = self.sharded.set_dead_shards(dead)
        if dead:
            self.stats["shard_failovers"] += 1
        else:
            self.stats["shard_heals"] += 1

    # -- scheduler core ---------------------------------------------------
    def _dispatch(self) -> None:
        sp = self.serve_params
        if (self.segments is not None
                and self.segments.generation != self._generation):
            # an out-of-band compact(): rebuild before dispatching
            self._build_stages()
            self.stats["stage_rebuilds"] += 1
        reqs = self.queue.drain(sp.buckets[-1])
        self._sync_queue_counters()
        if not reqs:
            return          # everything pending expired during the sweep
        degraded = self._should_degrade()
        nb = multistage.bucket_size(len(reqs), sp.buckets)
        q = np.zeros((nb, self.index.d), np.float32)
        for i, r in enumerate(reqs):
            q[i] = r.payload
        qr = self.index.rotate_queries(q)
        t = self._now()
        pilot_call = self._pilot_lo if degraded else self._pilot_call
        ready = None
        if self._card:
            self._pilot_stream.wait_stream(torch.cuda.current_stream())
        with self._on(self._pilot_stream if self._card else None):
            po = pilot_call(qr)
            if self._card:
                ready = torch.cuda.Event()
                ready.record()
        if degraded:
            self.stats["degraded_batches"] += 1
        dl = min((r.deadline for r in reqs if r.deadline is not None),
                 default=None)
        self._inflight.append((reqs, qr, po, ready, t, dl, degraded,
                               self.stats["batches"]))
        self.stats["batches"] += 1
        hist = self.stats["bucket_hist"]
        hist[nb] = hist.get(nb, 0) + 1

    def _drain_oldest(self) -> None:
        reqs, qr, po, ready, t_disp, dl, degraded, _ = self._inflight.pop(0)
        if self._fault_injector is not None:
            self._fault_injector.perturb_stage()  # slow_executable window
        t_cpu = self._now()
        # a degraded batch drains through its own rung's program
        cpu_call = self._cpu_lo if degraded else self._cpu_call
        rung = self._degraded_params if degraded else self.params
        with self._on(self._cpu_stream if self._card else None):
            if ready is not None:
                self._cpu_stream.wait_event(ready)
            ids, dists = cpu_call(qr, *po)        # po donated here
            with trace.span("readback"):
                ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
        if self.segments is not None:
            # exact cross-segment merge: base positional ids -> global ids,
            # delta top-k folded in, deletes since dispatch filtered
            ids, dists, _ = self.segments.merge_with_deltas(
                qr, ids, dists, self.params.k, rung)
        t_done = self._now()
        us_disp, us_cpu, us_done = (round(1e6 * t)
                                    for t in (t_disp, t_cpu, t_done))
        queued = 0
        for i, r in enumerate(reqs):
            r.complete((ids[i], dists[i]))
            self.stats["completed"] += 1
            self._completions[r.rid] = t_done
            self._lat_window.append(t_done - r.enqueued_at)
            queued += us_disp - round(1e6 * r.enqueued_at)
            if self.cache is not None:
                self.cache.insert(r.payload, r.result)
        trace.add({"engine.requests": len(reqs), "engine.queued_us": queued,
                   "engine.in_flight_us": len(reqs) * (us_cpu - us_disp),
                   "engine.drain_us": len(reqs) * (us_done - us_cpu)})
        self._svc_window.append(t_done - t_disp)
        self.stats["batch_records"].append(
            {"bucket": int(qr.shape[0]), "n_real": len(reqs),
             "t_pilot_dispatch": t_disp, "t_cpu_start": t_cpu,
             "t_done": t_done, "min_deadline": dl, "degraded": degraded})

    def pump(self) -> bool:
        """One scheduling action: dispatch a pilot batch if there is room
        (``len(inflight) < depth``) and the queue is ready, else drain the
        oldest in-flight batch.  Between batches up to
        ``mutations_per_pump`` mutation rows are applied; deferred
        semantic-cache maintenance runs only on otherwise idle cycles.  The
        shard heartbeats (failover and heal) and the hard-expiry sweep run
        first, and a ``queue_stall`` fault window suppresses dispatch.
        Returns False when there was nothing to do."""
        sp = self.serve_params
        self._check_shard_health()
        with trace.span("engine.expire" if self.queue.pending else None):
            expired = self.queue.expire_due()
        self._sync_queue_counters()
        stalled = (self._fault_injector is not None
                   and self._fault_injector.dispatch_stalled())
        if (not stalled and len(self._inflight) < sp.depth
                and self.queue.ready()):
            with trace.span("engine.dispatch", batch=self.stats["batches"]):
                self._dispatch()
            return True
        if self._inflight:
            with trace.span("engine.drain", batch=self._inflight[0][-1]):
                self._drain_oldest()
            with trace.span(self._mutation_span()):
                self._apply_mutations(sp.mutations_per_pump)
            return True
        with trace.span(self._mutation_span()):
            if self._apply_mutations(sp.mutations_per_pump):
                return True
        if self.cache is not None and self.cache.maintenance_pending:
            if self.cache.maintain():
                self.stats["cache_maintenance"] += 1
                return True
        return bool(expired)

    def flush(self) -> None:
        """Force-run everything pending (ignores the batching deadline, but
        honours hard expiry)."""
        while self.queue.pending:
            if len(self._inflight) >= self.serve_params.depth:
                self._drain_oldest()
            self._dispatch()
            self._sync_queue_counters()
        while self._inflight:
            self._drain_oldest()

    # -- offline driver ---------------------------------------------------
    def serve(self, queries: np.ndarray,
              arrival_times: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
        """Replay an arrival process through the runtime.

        queries: (n, d) raw query vectors; arrival_times: (n,) seconds
        relative to the call (default: all at t=0, a saturated closed
        loop).  Returns ``(ids (n, k), dists (n, k), stats)`` in submission
        order; ``stats`` covers this call only (counters, ``bucket_hist``,
        ``batch_records``, ``latency_s`` = completion − arrival per
        request, ``wall_s``, ``cache_hit_rate``, ``request_states``);
        ``self.stats`` keeps the lifetime totals.  A request that ends
        ``rejected`` or ``expired`` comes back as gid -1 / +inf with
        ``latency_s`` NaN."""
        queries = np.asarray(queries, np.float32)
        n = len(queries)
        arr = (np.zeros(n) if arrival_times is None
               else np.asarray(arrival_times, float))
        before = {k: self.stats[k] for k in
                  ("requests", "batches", "cache_lookups", "cache_hits",
                   "completed", "rejected", "expired", "shed",
                   "degraded_batches")}
        records_before = len(self.stats["batch_records"])
        hist_before = dict(self.stats["bucket_hist"])
        self._completions = {}
        t_start = self._now()
        reqs: List[Request] = []
        i = 0
        while i < n:
            now = self._now() - t_start
            while i < n and arr[i] <= now:
                reqs.append(self.submit(queries[i]))
                i += 1
            if i < n and not self.pump():
                time.sleep(min(max(arr[i] - (self._now() - t_start), 0.0),
                               5e-4))
        self.flush()
        wall = self._now() - t_start
        k = self.params.k
        ids = np.full((n, k), -1, np.int64)
        dists = np.full((n, k), np.inf, np.float32)
        lat = np.full(n, np.nan)
        for j, r in enumerate(reqs):
            if r.state == "completed":
                ids[j], dists[j] = r.result
                lat[j] = self._completions[r.rid] - t_start - arr[j]
        stats = {key: self.stats[key] - prev for key, prev in before.items()}
        stats["batch_records"] = self.stats["batch_records"][records_before:]
        stats["bucket_hist"] = {
            b: c - hist_before.get(b, 0)
            for b, c in self.stats["bucket_hist"].items()
            if c - hist_before.get(b, 0)}
        stats["latency_s"] = lat
        stats["request_states"] = [r.state for r in reqs]
        stats["wall_s"] = wall
        lookups, hits = stats["cache_lookups"], stats["cache_hits"]
        stats["cache_hit_rate"] = hits / lookups if lookups else 0.0
        return ids, dists, stats
