"""``closed_batch``: one client, a closed loop over ``index.search``: the
next batch of ``batch`` queries, drawn in turn from the query pool, is sent
when the previous one has returned.

Parameters: ``batch``; ``warm_seconds`` of the loop run before the window
(after the batch's CUDA graph is captured); ``trace_batches`` in the traced
window.
"""

from __future__ import annotations

import time

import numpy as np

from pilotbench import trace
from pilotbench.drivers import Window, launch_delta
from pilotbench.system import launch_counts


class Driver:
    def __init__(self, sut, pool: np.ndarray, traffic: dict, seed: int):
        self.sut, self.pool, self.seed = sut, pool, seed
        self.batch = int(traffic["batch"])
        self.warm_seconds = float(traffic.get("warm_seconds", 0.0))
        self.trace_batches = int(traffic.get("trace_batches", 16))
        self.n_batches = len(pool) // self.batch
        if self.n_batches < 1:
            raise ValueError(f"a pool of {len(pool)} queries holds no batch "
                             f"of {self.batch}")
        self.next = 0

    def setup(self) -> None:
        self.sut.index.warmup(self.sut.params, buckets=(self.batch,))
        t0 = time.perf_counter()
        self._one()
        while time.perf_counter() - t0 < self.warm_seconds:
            self._one()

    def _one(self, spans: bool = False):
        b = self.next % self.n_batches
        self.next += 1
        sl = np.arange(b * self.batch, (b + 1) * self.batch)
        with trace.span("search", spans):
            ids, dists, stats = self.sut.index.search(self.pool[sl],
                                                      self.sut.params)
        return sl, ids, dists, stats

    def _drive(self, stop, spans: bool = False) -> Window:
        before = launch_counts()
        qidx, ids, dists, due, done, stats = [], [], [], [], [], []
        t0 = time.perf_counter()
        while not stop(len(stats), time.perf_counter() - t0):
            t_send = time.perf_counter() - t0
            sl, i, d, st = self._one(spans)
            t = time.perf_counter() - t0
            qidx.append(sl)
            ids.append(i)
            dists.append(d)
            due.append(np.full(len(sl), t_send))
            done.append(np.full(len(sl), t))
            stats.append(st)
        end = done[-1][0] if done else 0.0
        return Window(seconds=end, n_due=sum(len(s) for s in qidx),
                      qidx=np.concatenate(qidx), ids=np.concatenate(ids),
                      dists=np.concatenate(dists), due_t=np.concatenate(due),
                      done_t=np.concatenate(done),
                      launches=launch_delta(before), open_loop=False,
                      batches=len(stats), batch_stats=stats)

    def run(self, seconds: float) -> Window:
        return self._drive(lambda n, t: t >= seconds)

    def trace(self):
        out = {}
        tr = trace.traced(
            lambda: out.setdefault("w", self._drive(
                lambda n, t: n >= self.trace_batches, spans=True)),
            self.sut.device, lead=lambda: [self._one() for _ in range(2)])
        return tr, out["w"]
