"""``open_churn``: ``open_poisson``'s open loop (independent single-query
requests, Poisson arrivals at ``rate`` a second, into the port's serving
engine over a ``SegmentedIndex``), with a fixed-period stream of mutations
beside it, all drawn from the seed.

Every ``period_s`` the driver submits one upsert of the next ``rows``
held-back rows (``sut.held``, in order: row ``n + j`` of the run's vectors
gets the global id ``n + j``, which the driver asserts on every ticket),
and half a period later one delete of ``rows`` ids drawn uniformly from the
rows that were live before that upsert, so that no row is deleted before
its own read-back.  When an upsert is seen done, a read-back follows: the
upsert's first row sent as a query, which has to find that row.  Set-up
builds the engine, applies ``preload_periods`` periods of the same stream
at once (``flush_mutations``), then drives ``warm_seconds`` of the
traffic.  A window ends once every request and every mutation it sent is
done, and hands the check every mutation since the index was built.

Parameters: ``open_poisson``'s, and ``period_s``, ``rows`` and
``preload_periods``.  A mutation that fails, an id assigned out of order
and held-back rows running out are errors: the run ends without a result.
"""

from __future__ import annotations

import time
from collections import deque
from pathlib import Path

import numpy as np

from pilotbench import drivers, trace
from pilotbench.drivers import MutationLog, Window, launch_delta
from pilotbench.system import engine, launch_counts

Base = drivers.load(Path(__file__).resolve().parents[2], "open_poisson")
DRAIN_S = 60.0      # how long past the window's close an answer may come
ENGINE_KEYS = ("batches", "completed", "upserts", "deletes",
               "mutation_time_s", "stage_rebuilds")


class Driver(Base):
    def __init__(self, sut, pool: np.ndarray, traffic: dict, seed: int):
        super().__init__(sut, pool, traffic, seed)
        self.period = float(traffic["period_s"])
        self.rows = int(traffic["rows"])
        self.preload = int(traffic.get("preload_periods", 0))
        self.held = (np.zeros((0, pool.shape[1]), np.float32)
                     if sut.held is None else sut.held)
        self.n_base = int(sut.index.n_total)
        self.alive = np.zeros(self.n_base + len(self.held), bool)
        self.alive[:self.n_base] = True
        self.upserts = 0                 # upserts submitted so far
        # the log: each mutation's kind, ids and the time it was seen done,
        # on the clock of the window in which it was (-inf in set-up)
        self.kinds, self.ids, self.done_t = [], [], []

    def setup(self) -> None:
        self.eng = engine(self.sut.index, self.sut.params, self.serve)
        pending = deque()
        for _ in range(self.preload):
            pending.append(self._upsert())
            pending.append(self._delete())
        self.eng.flush_mutations()
        self._landed(pending, -np.inf)
        if pending:
            raise RuntimeError(f"{len(pending)} preload mutations not done "
                               f"after flush_mutations()")
        self.run(self.warm_seconds)

    # -- the mutation stream ------------------------------------------------
    def _submit(self, kind: str, ids: np.ndarray, ticket):
        self.kinds.append(kind)
        self.ids.append(ids)
        self.done_t.append(np.inf)
        return len(self.kinds) - 1, ticket

    def _upsert(self):
        lo = self.upserts * self.rows
        if lo + self.rows > len(self.held):
            raise RuntimeError(
                f"the {len(self.held)} held-back rows ran out at upsert "
                f"{self.upserts} of {self.rows} rows: give the configuration "
                f"a larger data.n_insert")
        self.upserts += 1
        g = np.arange(self.n_base + lo, self.n_base + lo + self.rows)
        self.alive[g] = True
        return self._submit("insert", g, self.eng.submit_upsert(
            self.held[lo:lo + self.rows]))

    def _delete(self):
        """``rows`` distinct ids drawn from the seed among the rows live
        before the latest upsert: a deterministic function of the seed and
        the schedule, whatever the timing."""
        p = self.upserts - 1
        hi = self.n_base + p * self.rows
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 3, p]))
        pick = np.zeros(0, np.int64)
        while len(pick) < self.rows:
            c = rng.integers(0, hi, size=2 * self.rows)
            c = np.concatenate([pick, c[self.alive[c]]])
            _, first = np.unique(c, return_index=True)
            pick = c[np.sort(first)][:self.rows]
        self.alive[pick] = False
        return self._submit("delete", pick, self.eng.submit_delete(pick))

    def _landed(self, pending: deque, now: float) -> list:
        """Pops the mutations seen done at ``now`` (in submission order, as
        the engine applies them), logs the time and returns the inserts
        among them."""
        landed = []
        while pending and pending[0][1].done:
            j, t = pending.popleft()
            if t.failed:
                raise RuntimeError(f"a mutation ({t.kind}) failed: {t.error}")
            if t.kind == "insert":
                if not np.array_equal(t.gids, self.ids[j]):
                    raise RuntimeError(
                        f"upsert assigned ids {t.gids[:4]}... where "
                        f"{self.ids[j][:4]}... were due")
                landed.append(j)
            self.done_t[j] = now
        return landed

    def _captured(self) -> set:
        return {id(fn) for s in self.sut.index.deltas
                for fn in s.compiled.values()}

    # -- the window -----------------------------------------------------------
    def run(self, seconds: float, spans: bool = False) -> Window:
        eng = self.eng
        arr = self.arrivals(seconds, self.stream)
        self.stream += 1
        n = len(arr)
        pairs = max(0, int(np.ceil(seconds / self.period - 0.5)))
        m_t = np.repeat(self.period * np.arange(pairs), 2)
        m_t[1::2] += self.period / 2
        total = n + pairs
        qidx = np.full(total, -1, np.int64)
        qidx[:n] = (self.next + np.arange(n)) % len(self.pool)
        self.next += n
        k = self.sut.params.k
        ids = np.full((total, k), -1, np.int64)
        dists = np.full((total, k), np.inf, np.float32)
        due = np.zeros(total)
        due[:n] = arr
        submit = np.full(total, np.nan)
        done = np.full(total, np.nan)
        reads_back = np.full(total, -1, np.int64)
        extra = []
        late = 0.0
        before = launch_counts()
        captured = self._captured()
        st0 = {key: eng.stats[key] for key in ENGINE_KEYS}
        first = len(self.kinds)          # every earlier mutation is done
        outstanding, pending = deque(), deque()
        i = j = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while i < n and arr[i] <= now:
                with trace.span("submit", spans):
                    outstanding.append((i, eng.submit(self.pool[qidx[i]])))
                submit[i] = now
                late = max(late, now - arr[i])
                i += 1
            while j < len(m_t) and m_t[j] <= now:
                with trace.span("mutate", spans):
                    pending.append(self._delete() if j % 2 else
                                   self._upsert())
                j += 1
            if i >= n and j >= len(m_t) and not outstanding and not pending:
                break
            late_drain = now > seconds + DRAIN_S
            if late_drain:         # answers that still come are late
                eng.flush_mutations()
                eng.flush()
            with trace.span("pump", spans):
                worked = eng.pump()
            tn = time.perf_counter() - t0
            for m in self._landed(pending, tn):
                r = n + len(extra)
                row = int(self.ids[m][0])
                vec = self.held[row - self.n_base]
                with trace.span("submit", spans):
                    outstanding.append((r, eng.submit(vec)))
                qidx[r] = len(self.pool) + len(extra)
                due[r] = submit[r] = tn
                reads_back[r] = row
                extra.append(vec)
            while outstanding and outstanding[0][1].terminal:
                r, req = outstanding.popleft()
                if req.state == "completed":
                    ids[r], dists[r] = req.result
                    done[r] = tn
            if late_drain:
                break              # what never came counts as missing
            if not worked and (i < n or j < len(m_t)):
                nxt = min(arr[i] if i < n else np.inf,
                          m_t[j] if j < len(m_t) else np.inf)
                with trace.span("idle", spans):
                    time.sleep(min(max(nxt - tn, 0.0), 5e-4))
        sent = n + len(extra)
        ok = np.isfinite(done[:sent])
        counted = {key: eng.stats[key] - v for key, v in st0.items()}
        counted["delta_captures"] = len(self._captured() - captured)
        done_t = np.asarray(self.done_t, np.float64)
        done_t[:first] = -np.inf
        log = MutationLog(n_base=self.n_base, kinds=list(self.kinds),
                          ids=list(self.ids), done_t=done_t)

        def sel(a):
            return a[:sent][ok]
        return Window(
            seconds=seconds, n_due=sent, qidx=sel(qidx), ids=sel(ids),
            dists=sel(dists), due_t=sel(due), done_t=sel(done),
            launches=launch_delta(before), open_loop=True,
            batches=int(counted["batches"]), engine=counted, late_s=late,
            submit_t=sel(submit), reads_back=sel(reads_back),
            queries=np.stack(extra) if extra else None, mutations=log)
