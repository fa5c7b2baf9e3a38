"""Deterministic fault injection for the serving runtime (DESIGN.md §8) —
the port's own copy of ``repro.runtime.chaos`` (pure Python, as there).

The resilience contract of ``serving.ThroughputEngine`` — every request ends
in exactly one terminal state, SLO pressure degrades gracefully, a dead
shard fails over and heals back to bit-parity — is only testable if faults
are *reproducible*.  This module provides the two pieces:

* ``SimClock`` — a manually-advanced clock the queue, the heartbeat monitor
  and the fault windows all share, so a test script IS the timeline.
* ``FaultInjector`` — declarative fault windows checked by the engine at its
  existing decision points.  Injection is passive: the injector never calls
  into the engine; the engine consults it, which keeps the production code
  path identical when no injector is installed.

Supported fault kinds (the engine's reaction in parentheses):

  ``shard_stall``      transient: the shard stops heartbeating for the
                       window (failover to degraded mode once the
                       HeartbeatMonitor timeout lapses; heal on return).
  ``shard_loss``       permanent until ``clear()``: same mechanism as a
                       stall, modelling a host loss rather than a hiccup.
  ``slow_executable``  every drained batch costs ``severity`` extra seconds
                       (SimClock: advanced; real clock: slept) — inflates
                       observed latency so rolling-p99 degradation engages.
  ``queue_stall``      dispatch is suppressed for the window — pending work
                       ages toward its deadline/expiry (admission and
                       expiry enforcement under backlog).
  ``mutation_failure`` the mutation drain raises ``ChaosError`` for the
                       window (exercises RestartPolicy retry/backoff and
                       the give-up path).

``tests/test_torch_resilience.py`` drives the port's engine through these,
as ``tests/test_resilience.py`` drives the reference's; the shard faults
stall the heartbeats of a ``core/distributed.ShardedSegmentedIndex``'s
shards.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

FAULT_KINDS = ("shard_stall", "shard_loss", "slow_executable",
               "queue_stall", "mutation_failure")


class ChaosError(RuntimeError):
    """Raised by injected ``mutation_failure`` faults (never by real code)."""


class SimClock:
    """Manually-advanced monotonic clock.  Pass the instance itself as the
    ``clock=`` callable of BatchingQueue / HeartbeatMonitor /
    ThroughputEngine / FaultInjector so they share one timeline."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a monotonic clock by {dt}")
        self._now += dt
        return self._now


@dataclass
class Fault:
    """One injected fault window: active on ``start <= now < end``."""
    kind: str
    start: float
    end: float = math.inf            # inf = until clear()
    shard: Optional[int] = None      # shard faults; None = any shard
    severity: float = 0.0            # slow_executable: seconds per batch

    def active(self, now: float) -> bool:
        return self.start <= now < self.end


class FaultInjector:
    """Holds fault windows; the engine polls it at its decision points.

    ``log`` records every time a fault actually fired (kind, shard, time) —
    tests assert faults were exercised, not merely scheduled."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.faults: List[Fault] = []
        self.log: List[Dict] = []

    # -- scheduling --------------------------------------------------------
    def inject(self, kind: str, *, shard: Optional[int] = None,
               start: Optional[float] = None,
               duration: Optional[float] = None,
               severity: float = 0.0) -> Fault:
        """Schedule a fault window starting at ``start`` (default: now) for
        ``duration`` seconds (default: until ``clear()``)."""
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"one of {FAULT_KINDS}")
        t0 = self.clock() if start is None else float(start)
        t1 = math.inf if duration is None else t0 + float(duration)
        f = Fault(kind, t0, t1, shard=shard, severity=severity)
        self.faults.append(f)
        return f

    def clear(self, kind: Optional[str] = None,
              shard: Optional[int] = None) -> int:
        """Remove matching faults (kind=None: all); returns #removed."""
        keep = [f for f in self.faults
                if (kind is not None and f.kind != kind)
                or (shard is not None and f.shard != shard)]
        removed = len(self.faults) - len(keep)
        self.faults = keep
        return removed

    # -- queries (engine-facing) ------------------------------------------
    def active(self, kind: str, *, shard: Optional[int] = None
               ) -> Optional[Fault]:
        """First active fault of ``kind`` (optionally scoped to a shard)."""
        now = self.clock()
        for f in self.faults:
            if f.kind == kind and f.active(now) \
                    and (shard is None or f.shard is None or f.shard == shard):
                return f
        return None

    def stalled_shards(self) -> set:
        """Shards with an active ``shard_stall`` / ``shard_loss`` fault —
        the engine suppresses their heartbeats while this is non-empty."""
        now = self.clock()
        return {f.shard for f in self.faults
                if f.kind in ("shard_stall", "shard_loss")
                and f.active(now) and f.shard is not None}

    # -- perturbations (engine-facing) ------------------------------------
    def perturb_stage(self) -> float:
        """Apply an active ``slow_executable`` fault to the current batch:
        advances a SimClock (or sleeps a real one) by ``severity`` seconds.
        Returns the injected delay (0.0 when no fault is active)."""
        f = self.active("slow_executable")
        if f is None or f.severity <= 0:
            return 0.0
        if hasattr(self.clock, "advance"):
            self.clock.advance(f.severity)
        else:
            time.sleep(f.severity)
        self.log.append({"t": self.clock(), "kind": f.kind,
                         "severity": f.severity})
        return f.severity

    def mutation_should_fail(self) -> bool:
        """True while a ``mutation_failure`` window is active (the engine's
        mutation drain raises ``ChaosError`` and goes through RestartPolicy
        backoff)."""
        f = self.active("mutation_failure")
        if f is None:
            return False
        self.log.append({"t": self.clock(), "kind": f.kind})
        return True

    def dispatch_stalled(self) -> bool:
        """True while a ``queue_stall`` window is active (the engine skips
        batch dispatch; pending work ages toward deadline/expiry)."""
        f = self.active("queue_stall")
        if f is None:
            return False
        self.log.append({"t": self.clock(), "kind": f.kind})
        return True
