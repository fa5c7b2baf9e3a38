"""``open_poisson``: independent single-query requests with Poisson
arrivals at ``rate`` a second (open loop) into the port's serving engine
(``serve`` holds its ``ServeParams``), pumped by this process.  Each request
is timed on the benchmark's own clock from the moment it was due, so a
stall delays every request that arrives behind it.

Parameters: ``rate``; ``serve``; ``warm_seconds`` of traffic before the
window (after the engine has captured its stage programs);
``trace_seconds`` of arrivals in the traced window.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from pilotbench import trace
from pilotbench.drivers import Window, launch_delta
from pilotbench.system import engine, launch_counts

DRAIN_S = 60.0      # how long past the window's close an answer may come


class Driver:
    def __init__(self, sut, pool: np.ndarray, traffic: dict, seed: int):
        self.sut, self.pool, self.seed = sut, pool, seed
        self.rate = float(traffic["rate"])
        self.serve = dict(traffic.get("serve", {}))
        self.warm_seconds = float(traffic.get("warm_seconds", 1.0))
        self.trace_seconds = float(traffic.get("trace_seconds", 1.0))
        self.next = 0
        self.stream = 0
        self.eng = None

    def setup(self) -> None:
        self.eng = engine(self.sut.index, self.sut.params, self.serve)
        self.run(self.warm_seconds)

    def arrivals(self, seconds: float, stream: int) -> np.ndarray:
        """Poisson arrival times in [0, seconds) from the seed."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 1, stream]))
        n = int(self.rate * seconds * 1.2) + 64
        t = np.cumsum(rng.exponential(1.0 / self.rate, n))
        while t[-1] < seconds:
            t = np.concatenate(
                [t, t[-1] + np.cumsum(rng.exponential(1.0 / self.rate, n))])
        return t[t < seconds]

    def run(self, seconds: float, spans: bool = False) -> Window:
        eng = self.eng
        arr = self.arrivals(seconds, self.stream)
        self.stream += 1
        n = len(arr)
        qidx = (self.next + np.arange(n)) % len(self.pool)
        self.next += n
        k = self.sut.params.k
        ids = np.full((n, k), -1, np.int64)
        dists = np.full((n, k), np.inf, np.float32)
        done = np.full(n, np.nan)
        late = 0.0
        before = launch_counts()
        st0 = {key: eng.stats[key] for key in ("batches", "completed")}
        outstanding = deque()
        i = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while i < n and arr[i] <= now:
                with trace.span("submit", spans):
                    outstanding.append((i, eng.submit(self.pool[qidx[i]])))
                late = max(late, now - arr[i])
                i += 1
            if i >= n and not outstanding:
                break
            late_drain = now > seconds + DRAIN_S
            if late_drain:
                eng.flush()        # answers that still come are late
            with trace.span("pump", spans):
                worked = eng.pump()
            tn = time.perf_counter() - t0
            while outstanding and outstanding[0][1].terminal:
                j, r = outstanding.popleft()
                if r.state == "completed":
                    ids[j], dists[j] = r.result
                    done[j] = tn
            if late_drain:
                break              # what never came counts as missing
            if not worked and i < n:
                with trace.span("idle", spans):
                    time.sleep(min(max(arr[i] - tn, 0.0), 5e-4))
        ok = np.isfinite(done)
        counted = {key: eng.stats[key] - v for key, v in st0.items()}
        return Window(
            seconds=seconds, n_due=n, qidx=qidx[ok], ids=ids[ok],
            dists=dists[ok], due_t=arr[ok], done_t=done[ok],
            launches=launch_delta(before), open_loop=True,
            batches=int(counted["batches"]), engine=counted, late_s=late)

    def trace(self):
        out = {}
        tr = trace.traced(
            lambda: out.setdefault("w", self.run(self.trace_seconds,
                                                 spans=True)),
            self.sut.device)
        return tr, out["w"]
