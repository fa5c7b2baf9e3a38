"""Fault-tolerance primitives for the serving pod: heartbeats, restart
policy, elastic re-meshing, straggler mitigation — the port's own copy of
``repro.runtime.fault_tolerance`` (pure Python, as there).

These are the mechanisms ``serving.ThroughputEngine`` wires into its pump
loop (DESIGN.md §8); on one host they are exercised
deterministically through injected clocks and ``runtime/chaos.py`` fault
windows, and the same objects drop onto a real multi-host pod unchanged:

  * HeartbeatMonitor — per-shard liveness with timeout-based failure
    detection.  The engine beats every responsive shard once per pump; a
    shard quiet past the timeout triggers tombstone-overlay failover on the
    ``ShardedSegmentedIndex`` (degraded survivors-only serving), and beats
    resuming heal it back to bit-parity.
  * RestartPolicy    — bounded exponential backoff for failing mutation
    drains.  Retries are idempotent by ``MutationTicket.seq`` (an applied
    ticket is never re-applied; re-queued tickets keep their seq, so the
    global replay order is preserved); ``next_backoff() is None`` is the
    give-up signal — the engine then terminates the tickets as ``failed``
    instead of retrying forever.
  * ElasticPolicy    — decides a new mesh shape when hosts are lost.  Note
    this models a TRAINING mesh (fixed tensor-parallel 'model' axis, the
    historical default of 16, with elastic 'data'/'pod' axes); the serving
    pod's 1-axis ("shard",) mesh does not re-mesh on failure — it degrades
    via tombstone overlay and heals in place — so the serving engine does
    not consume this policy.  Kept for trainers colocated with serving.
  * StragglerMitigator — duplicate-issue of the slowest shards' work
    (backup tasks) once their latency exceeds p50 * factor,
    first-result-wins; pairs with ``BatchingQueue.requeue``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class HeartbeatMonitor:
    """Timeout-based liveness over named hosts (serving: one ``"shard:i"``
    entry per shard).  ``beat`` refreshes a host; ``dead_hosts`` is
    evaluated lazily against the injected clock, so a host can go dead and
    come back alive purely by beating again — the heal-on-return contract
    the serving failover relies on (no explicit recovery call)."""

    def __init__(self, hosts: Sequence[str], *, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        now = clock()
        self.last_seen: Dict[str, float] = {h: now for h in hosts}

    def beat(self, host: str) -> None:
        self.last_seen[host] = self.clock()

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]

    def alive_hosts(self) -> List[str]:
        dead = set(self.dead_hosts())
        return [h for h in self.last_seen if h not in dead]


@dataclass
class RestartPolicy:
    """Bounded exponential backoff for a retryable unit of work.

    The serving engine keeps one per mutation queue: each failing drain
    consumes ``next_backoff()`` (doubling from ``base_backoff_s``, capped
    at ``max_backoff_s``); a success resets ``restarts`` to 0; ``None``
    means the budget is exhausted — give up and surface the failure
    (``MutationTicket.failed``) rather than retry forever."""
    max_restarts: int = 100
    base_backoff_s: float = 5.0
    max_backoff_s: float = 300.0
    restarts: int = 0

    def next_backoff(self) -> Optional[float]:
        """None = give up."""
        if self.restarts >= self.max_restarts:
            return None
        b = min(self.base_backoff_s * (2 ** min(self.restarts, 6)),
                self.max_backoff_s)
        self.restarts += 1
        return b

    def replay_from(self, checkpoint_step: Optional[int]) -> int:
        """Step to resume a *training* loop at after a restart (checkpoints
        are post-step; replay is exact when the data pipeline is pure in
        (seed, step)).  The serving engine's unit of replay is the mutation
        ticket, not a step — it re-queues tickets by ``seq`` and never
        consults this."""
        return 0 if checkpoint_step is None else checkpoint_step + 1


@dataclass
class ElasticPolicy:
    """Shrink/grow a TRAINING mesh as hosts come and go: 'model' (TP) stays
    fixed because parameter layout depends on it, 'pod'/'data' absorb the
    change.  NOT used by the serving pod — its 1-axis ("shard",) mesh
    never re-shapes on failure (a re-mesh would re-shard the cold tables
    and recompile every stage executable mid-incident); it masks the dead
    shard's rows instead (core/distributed.set_dead_shards, DESIGN.md §8)
    and heals in place."""
    model_degree: int = 16
    min_data_degree: int = 1

    def propose_mesh(self, chips_alive: int) -> Optional[Tuple[Tuple[int, ...],
                                                               Tuple[str, ...]]]:
        usable = (chips_alive // self.model_degree) * self.model_degree
        data = usable // self.model_degree
        if data < self.min_data_degree:
            return None
        # prefer splitting an explicit 'pod' axis when data is large & even
        if data % 16 == 0 and data // 16 >= 2:
            return ((data // 16, 16, self.model_degree), ("pod", "data", "model"))
        return ((data, self.model_degree), ("data", "model"))

    def global_batch_for(self, base_global_batch: int, base_data: int,
                         new_data: int) -> int:
        """Keep per-replica batch constant; scale global batch with the mesh
        (linear-scaling rule; optimizer LR schedule consumes tokens, so the
        token-based schedule is unchanged)."""
        per = base_global_batch // base_data
        return per * new_data


@dataclass
class _ShardRecord:
    issued_at: float
    done: bool = False
    backup_issued: bool = False


class StragglerMitigator:
    """Track per-shard latency; issue backup work for outliers."""

    def __init__(self, *, factor: float = 3.0, min_history: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        self.factor = factor
        self.min_history = min_history
        self.clock = clock
        self.history: List[float] = []
        self.inflight: Dict[str, _ShardRecord] = {}

    def issue(self, shard_id: str) -> None:
        self.inflight[shard_id] = _ShardRecord(issued_at=self.clock())

    def complete(self, shard_id: str) -> None:
        rec = self.inflight.pop(shard_id, None)
        if rec is not None and not rec.done:
            self.history.append(self.clock() - rec.issued_at)
            if len(self.history) > 256:
                self.history = self.history[-128:]

    def backups_needed(self) -> List[str]:
        """Shards whose latency exceeds p50 * factor — issue duplicates
        (first result wins; pure (seed, step) shards make this safe)."""
        if len(self.history) < self.min_history:
            return []
        hist = sorted(self.history)
        p50 = hist[len(hist) // 2]
        now = self.clock()
        out = []
        for sid, rec in self.inflight.items():
            if not rec.backup_issued and now - rec.issued_at > p50 * self.factor:
                rec.backup_issued = True
                out.append(sid)
        return out
