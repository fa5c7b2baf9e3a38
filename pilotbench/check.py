"""The comparison that decides ``correct``.

Every answer of the measured window is judged against the plain reference
(``reference.py``) on the vectors and queries the benchmark made.  Four
numbers, each against its limit from the configuration's ``limits``:

* ``missing``: answers due in the window that never came, or came as
  anything but a completed result (limit 0);
* ``bad_rows``: answers with an id outside the ids assigned so far
  (``[0, n)`` on a corpus that does not change), an id twice, a distance
  that is not finite, or distances out of ascending order (limit 0);
* ``dist_err``: the widest gap between a returned distance and the fp64
  squared distance of the same (query, id), over ``|q|^2 + |x|^2`` (the
  scale an fp32 distance's rounding grows with);
* ``recall_miss``: 1 - recall@k of all answers against the reference's
  exact top k; its limit is the recall the configuration guarantees.

A window that changed the corpus (``Window.mutations``) is judged by
``judge_live``: each answer against the rows that were live when its
request was submitted (the base rows and those whose upsert was done
before the submit, less the ids whose delete was done before it), and two
more numbers, each reported only where the configuration's ``limits``
names it:

* ``dead_ids``: answers holding an id whose delete was done before the
  request was submitted, or an id not yet assigned when the answer
  completed (limit 0);
* ``unread_writes``: the share of read-back queries (a query that is an
  upserted row, sent once its upsert is done) whose own row is not among
  their k, of those whose row was not deleted before they completed.

``correct`` is true when each number is at or under its limit.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pilotbench import reference

ORDER = ("missing", "bad_rows", "dist_err", "recall_miss", "dead_ids",
         "unread_writes")


class _Tally:
    """The counts that ``judge`` and ``judge_live`` add up block by block."""

    def __init__(self, x: torch.Tensor, q: torch.Tensor):
        self.x, self.q = x, q
        self.bad = self.dead = self.hits = 0
        self.worst = 0.0

    def add(self, qi: torch.Tensor, a_ids: torch.Tensor, a_d: torch.Tensor,
            gt: torch.Tensor, n_assigned: torch.Tensor,
            deleted: Optional[torch.Tensor] = None) -> None:
        """One block of answers ``a_ids``/``a_d`` (b, k) to the queries
        ``qi`` (b,), with the exact ids ``gt`` (b, k), the ids assigned so
        far ``n_assigned`` (b,) and, where the corpus changed, the ids
        deleted before each request's submit (``deleted``, (N,) bool)."""
        assigned = (a_ids >= 0) & (a_ids < n_assigned[:, None])
        srt = torch.sort(a_ids, dim=1).values
        distinct = (srt[:, 1:] != srt[:, :-1]).all(1)
        finite = torch.isfinite(a_d).all(1)
        ascending = (a_d[:, 1:] >= a_d[:, :-1]).all(1)
        ok = assigned.all(1) & distinct & finite & ascending
        self.bad += int((~ok).sum())
        if bool(ok.any()):
            rows = ok.nonzero().flatten()
            d64, scale = reference.pair_dists64(self.x, self.q[qi[rows]],
                                                a_ids[rows])
            gap = (a_d[rows].double() - d64).abs() / scale.clamp_min(1e-30)
            self.worst = max(self.worst, float(gap.max()))
        self.hits += int((a_ids[:, :, None] == gt[:, None, :]).any(2).sum())
        if deleted is not None:
            n = deleted.shape[0]
            gone = deleted[a_ids.clamp(0, n - 1)] & (a_ids >= 0) & (a_ids < n)
            self.dead += int((gone | ((a_ids >= 0) & ~assigned)).any(1).sum())

    def readings(self, n_due: int, answered: int, k: int
                 ) -> Dict[str, float]:
        recall = self.hits / (max(answered, 1) * k)
        return {"missing": float(n_due - answered),
                "bad_rows": float(self.bad), "dist_err": self.worst,
                "recall_miss": 1.0 - recall}


def _blocks(ids, dists, rows: np.ndarray, dev, block: int):
    for s in range(0, len(rows), block):
        r = rows[s:s + block]
        yield (r, torch.from_numpy(np.asarray(ids[r], np.int64)).to(dev),
               torch.from_numpy(np.asarray(dists[r], np.float32)).to(dev))


def judge(x: torch.Tensor, q: torch.Tensor, gt: torch.Tensor,
          qidx: np.ndarray, ids: np.ndarray, dists: np.ndarray,
          n_due: int, block: int = 8192) -> Dict[str, float]:
    """The four numbers for answers ``ids``/``dists`` (A, k) to the pool
    queries ``qidx`` (A,); ``x`` (n, d) and ``q`` (Q, d) on the device the
    reference runs on, ``gt`` (Q, k) its exact ids."""
    dev = x.device
    tally = _Tally(x, q)
    qidx = np.asarray(qidx, np.int64)
    for r, a_ids, a_d in _blocks(ids, dists, np.arange(len(qidx)), dev,
                                 block):
        qi = torch.from_numpy(qidx[r]).to(dev)
        n = torch.full((len(r),), x.shape[0], dtype=torch.int64, device=dev)
        tally.add(qi, a_ids, a_d, gt[qi], n)
    return tally.readings(n_due, len(qidx), gt.shape[1])


def judge_live(x: torch.Tensor, q: torch.Tensor, w, k: int,
               block: int = 8192) -> Dict[str, float]:
    """The six numbers for the answers of window ``w`` (``drivers.Window``
    with a ``MutationLog``), judged against the rows live at each request's
    submit.  ``x`` (N, d) holds every row the run made, the base first;
    ``q`` the pool, then ``w.queries``.  The answers are grouped by the
    number of mutations done before their submit, and each group has one
    masked exact search of its own."""
    dev = x.device
    N = x.shape[0]
    log = w.mutations
    qidx = np.asarray(w.qidx, np.int64)
    submit = np.asarray(w.due_t if w.submit_t is None else w.submit_t,
                        np.float64)
    done = np.asarray(w.done_t, np.float64)
    n_base, kinds = log.n_base, log.kinds
    t_done = np.asarray(log.done_t, np.float64)
    order = np.argsort(t_done, kind="stable")
    # ids assigned by each answer's completion: the inserts are in order
    ins = [i for i in order if kinds[i] == "insert"]
    ins_t = t_done[ins]
    top = np.maximum.accumulate(np.array(
        [n_base] + [int(log.ids[i].max()) + 1 for i in ins], np.int64))
    n_assigned = top[np.searchsorted(ins_t, done, side="right")]
    # the first delete of each id, for the read-backs
    del_t = np.full(N, np.inf)
    for i in order:
        if kinds[i] == "delete":
            g = log.ids[i]
            del_t[g] = np.minimum(del_t[g], t_done[i])
    epoch = np.searchsorted(t_done[order], submit, side="right")
    inserted = torch.zeros(N, dtype=torch.bool, device=dev)
    inserted[:n_base] = True
    deleted = torch.zeros(N, dtype=torch.bool, device=dev)
    tally = _Tally(x, q)
    applied = 0
    for e in np.unique(epoch):
        for i in order[applied:e]:
            g = torch.from_numpy(np.asarray(log.ids[i], np.int64)).to(dev)
            (inserted if kinds[i] == "insert" else deleted)[g] = True
        applied = e
        live = inserted & ~deleted
        rows = np.flatnonzero(epoch == e)
        for r, a_ids, a_d in _blocks(w.ids, w.dists, rows, dev, block):
            qi = torch.from_numpy(qidx[r]).to(dev)
            gt, _ = reference.exact_knn(x, q[qi], k, live=live)
            tally.add(qi, a_ids, a_d, gt,
                      torch.from_numpy(n_assigned[r]).to(dev), deleted)
    out = tally.readings(w.n_due, len(qidx), k)
    out["dead_ids"] = float(tally.dead)
    rb = (np.full(len(qidx), -1, np.int64) if w.reads_back is None
          else np.asarray(w.reads_back, np.int64))
    asked = rb >= 0
    asked[asked] &= del_t[rb[asked]] > done[asked]
    found = (np.asarray(w.ids)[asked] == rb[asked, None]).any(1)
    out["unread_writes"] = (float((~found).sum()) / int(asked.sum())
                            if asked.any() else 0.0)
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` in a fixed order, for the result's
    last key and the last lines of standard error: the four standing
    numbers, then each further one the configuration's ``limits`` names.
    A named number the run could not read is NaN, and not correct."""
    return {name: {"value": readings.get(name, float("nan")),
                   "limit": float(limits[name])}
            for name in ORDER if name in limits or ORDER.index(name) < 4}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
