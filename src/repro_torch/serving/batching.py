"""Request batching with admission control, deadlines and priorities —
the port's own copy of ``repro.serving.batching`` (pure Python, as there;
the reference's ``jax_index`` helper is ``row_of`` here).

The serving loop collects requests into fixed-size batches (padding the tail
with no-op slots so compiled shapes never change), honours a max-wait
deadline so p99 latency is bounded at low load, and requeues work from shards
that miss their deadline (first-result-wins, paired with
runtime.StragglerMitigator).

Resilient-serving extensions (DESIGN.md §8):

* **Terminal-state machine** — every ``Request`` ends in exactly ONE of
  ``completed`` / ``rejected`` / ``expired`` (a second transition raises),
  so overload can never silently drop work: a request the runtime will not
  serve is explicitly rejected (with a reason) or expired, and the queue's
  ``counters`` stay conserved (``submitted == pending + drained terminal``).
* **Admission control** — ``max_pending`` bounds the queue.  A submit over
  the bound sheds the lowest-priority pending request if the newcomer
  outranks it, else rejects the newcomer with reason ``queue_full``.
* **Priorities** — ``pending`` is kept ordered by priority (higher first),
  FIFO within a class, so ``drain`` serves important traffic first and load
  shedding always drops from the low-priority tail.  All-default priorities
  reduce to the historical pure-FIFO behavior.
* **Expiry** — ``deadline`` stays the *dispatch-by* target that triggers
  batch formation (``ready()``); the new ``expiry`` is the hard SLO cutoff
  after which a result is useless.  ``expire_due()`` (called from
  ``ready``/``drain``/``submit``, i.e. at least once per engine pump)
  terminates overdue pending requests as ``expired``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

#: the three ways a request can leave the ``pending`` state — see Request.
TERMINAL_STATES = ("completed", "rejected", "expired")


@dataclass
class Request:
    rid: int
    payload: Any
    enqueued_at: float = field(default_factory=time.monotonic)
    # absolute dispatch deadline (queue-clock domain); ``submit`` defaults it
    # to ``enqueued_at + max_wait_s``.  Carried through ``drain``/``requeue``
    # round-trips, scheduled against by ``ready()`` and surfaced per batch in
    # the serving engine's ``batch_records``.  This is the SOFT target that
    # *triggers* dispatch — the hard cutoff is ``expiry``.
    deadline: Optional[float] = None
    result: Any = None
    done: bool = False
    # admission-control surface (DESIGN.md §8): higher priority is shed
    # later and drained first; ``expiry`` (absolute, queue-clock domain,
    # None = never) terminates the request as ``expired`` if it is still
    # pending when the cutoff passes.
    priority: int = 0
    expiry: Optional[float] = None
    # terminal-state machine: pending -> completed | rejected | expired,
    # exactly once (enforced by ``_transition``); ``reject_reason`` names
    # why admission refused the request (e.g. "queue_full", "shed").
    state: str = "pending"
    reject_reason: Optional[str] = None

    @property
    def terminal(self) -> bool:
        return self.state != "pending"

    def _transition(self, state: str, reason: Optional[str] = None) -> None:
        if self.state != "pending":
            raise RuntimeError(
                f"request {self.rid}: illegal second terminal transition "
                f"{self.state!r} -> {state!r}")
        assert state in TERMINAL_STATES, state
        self.state = state
        self.reject_reason = reason

    def complete(self, result: Any) -> "Request":
        """pending -> completed (the only state that sets ``done``)."""
        self._transition("completed")
        self.result = result
        self.done = True
        return self

    def reject(self, reason: str) -> "Request":
        """pending -> rejected: admission control refused the request."""
        self._transition("rejected", reason)
        return self

    def expire(self) -> "Request":
        """pending -> expired: the hard ``expiry`` cutoff passed before
        dispatch.  Never silent — the request object records it."""
        self._transition("expired")
        return self


class BatchingQueue:
    def __init__(self, batch_size: int, *, max_wait_s: float = 0.01,
                 clock: Callable[[], float] = time.monotonic,
                 max_pending: Optional[int] = None):
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self.max_pending = max_pending
        self.clock = clock
        self.pending: Deque[Request] = deque()
        self._next_rid = 0
        # monotone admission counters (never reset, never decremented):
        # submitted = accepted + rejected; expired/shed subsets accounted
        # separately.  The engine mirrors these into its ``stats``.
        self.counters: Dict[str, int] = {
            "submitted": 0, "accepted": 0, "rejected": 0, "expired": 0,
            "shed": 0}

    # -- admission ---------------------------------------------------------
    def submit(self, payload: Any, *, deadline: Optional[float] = None,
               expiry: Optional[float] = None, priority: int = 0) -> Request:
        """Admit one request, or terminate it as ``rejected`` on overload.

        Always returns the ``Request`` — callers check ``state`` (an
        admission refusal is ``rejected`` with ``reject_reason``; it was
        never enqueued).  When the queue is at ``max_pending``, expired
        work is swept first; if still full, the lowest-priority pending
        request is shed (rejected, reason "shed") iff the newcomer
        strictly outranks it, else the newcomer itself is rejected with
        reason "queue_full"."""
        req = Request(self._next_rid, payload, enqueued_at=self.clock(),
                      deadline=deadline, expiry=expiry, priority=priority)
        if req.deadline is None:
            req.deadline = req.enqueued_at + self.max_wait_s
        self._next_rid += 1
        self.counters["submitted"] += 1
        if self.max_pending is not None \
                and len(self.pending) >= self.max_pending:
            self.expire_due()                 # expired work frees slots first
        if self.max_pending is not None \
                and len(self.pending) >= self.max_pending:
            victim = self.pending[-1]         # lowest priority, newest
            if victim.priority < req.priority:
                self.pending.pop()
                victim.reject("shed")
                self.counters["rejected"] += 1
                self.counters["shed"] += 1
            else:
                req.reject("queue_full")
                self.counters["rejected"] += 1
                return req
        self._insert(req)
        self.counters["accepted"] += 1
        return req

    def _insert(self, req: Request, *, front_of_class: bool = False) -> None:
        """Insert keeping ``pending`` ordered by (priority desc, FIFO).
        ``front_of_class`` places the request BEFORE its equals (requeued
        work is older than anything queued since)."""
        p = self.pending
        if not front_of_class and (not p or p[-1].priority >= req.priority):
            p.append(req)                     # all-default fast path
            return
        for i, r in enumerate(p):
            ahead = (r.priority > req.priority if front_of_class
                     else r.priority >= req.priority)
            if not ahead:
                p.insert(i, req)
                return
        p.append(req)

    # -- expiry ------------------------------------------------------------
    def expire_due(self, now: Optional[float] = None) -> List[Request]:
        """Terminate every pending request whose hard ``expiry`` cutoff has
        passed (state -> ``expired``, removed from the queue); returns them.
        Called from ``ready``/``drain``/``submit`` so enforcement happens at
        least once per engine pump."""
        now = self.clock() if now is None else now
        due = [r for r in self.pending
               if r.expiry is not None and now >= r.expiry]
        if not due:
            return []
        for r in due:
            r.expire()
        self.counters["expired"] += len(due)
        self.pending = deque(r for r in self.pending if r.state == "pending")
        return due

    # -- batch formation ---------------------------------------------------
    def ready(self) -> bool:
        """A batch is ready when it is full or the EARLIEST pending deadline
        has passed.  For default deadlines FIFO order makes the head the
        earliest (the historical head-age check), but an explicit tight
        deadline mid-queue — or a requeued straggler carrying its original
        deadline — must be able to trigger dispatch too; the old head-only
        age check silently ignored both."""
        self.expire_due()
        if not self.pending:
            return False
        if len(self.pending) >= self.batch_size:
            return True
        return self.clock() >= min(r.deadline for r in self.pending)

    def next_batch(self) -> List[Optional[Request]]:
        """Fixed-size batch: real requests + None padding (compiled-shape
        stability — the engine scores padded slots against zero queries)."""
        out: List[Optional[Request]] = [None] * self.batch_size
        for i, r in enumerate(self.drain(self.batch_size)):
            out[i] = r
        return out

    def drain(self, max_n: int) -> List[Request]:
        """Pop up to ``max_n`` requests in (priority desc, FIFO) order, no
        padding — the serving runtime's bucket path pads the result to its
        shape ladder instead (serving/server.py, DESIGN.md §5).  Expired
        work is swept first, so a drained request is never past its hard
        cutoff at dispatch time."""
        self.expire_due()
        out: List[Request] = []
        while self.pending and len(out) < max_n:
            out.append(self.pending.popleft())
        return out

    def requeue(self, reqs: List[Request]) -> None:
        """Return unfinished requests to the FRONT of their priority class,
        preserving their relative order (requeue([a, b]) leaves a before b),
        so retried stragglers keep their original position: older than
        anything of equal priority queued since, still behind strictly
        higher priorities.  Terminal requests are skipped.  ``max_pending``
        stays a HARD bound: if the returning stragglers push past it, the
        low-priority tail is shed (explicitly rejected — never silently
        dropped)."""
        for r in reversed(reqs):
            if not r.done and not r.terminal:
                self._insert(r, front_of_class=True)
        while self.max_pending is not None \
                and len(self.pending) > self.max_pending:
            self.pending.pop().reject("shed")
            self.counters["rejected"] += 1
            self.counters["shed"] += 1


def run_query_batches(engine_fn: Callable[[np.ndarray], Any],
                      queue: BatchingQueue, d: int, *,
                      max_batches: Optional[int] = None) -> int:
    """Drain the queue through the engine; returns #batches executed."""
    n = 0
    while queue.pending and (max_batches is None or n < max_batches):
        batch = queue.next_batch()
        q = np.zeros((len(batch), d), np.float32)
        for i, r in enumerate(batch):
            if r is not None:
                q[i] = r.payload
        results = engine_fn(q)
        for i, r in enumerate(batch):
            if r is not None:
                r.complete(row_of(results, i))
        n += 1
    return n


def row_of(results, i):
    """Row ``i`` of a batch result (an array, or a tuple of arrays) as numpy
    (the reference's ``jax_index``)."""
    if isinstance(results, tuple):
        return tuple(np.asarray(r)[i] for r in results)
    return np.asarray(results)[i]
