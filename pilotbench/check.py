"""The comparison that decides ``correct``.

Every answer of the measured window is judged against the plain reference
(``reference.py``) on the vectors and queries the benchmark made.  Four
numbers, each against its limit from the configuration's ``limits``:

* ``missing``: answers due in the window that never came, or came as
  anything but a completed result (limit 0);
* ``bad_rows``: answers with an id outside ``[0, n)``, an id twice, a
  distance that is not finite, or distances out of ascending order
  (limit 0);
* ``dist_err``: the widest gap between a returned distance and the fp64
  squared distance of the same (query, id), over ``|q|^2 + |x|^2`` (the
  scale an fp32 distance's rounding grows with);
* ``recall_miss``: 1 - recall@k of all answers against the reference's
  exact top k; its limit is the recall the configuration guarantees.

``correct`` is true when each number is at or under its limit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pilotbench import reference

ORDER = ("missing", "bad_rows", "dist_err", "recall_miss")


def judge(x: torch.Tensor, q: torch.Tensor, gt: torch.Tensor,
          qidx: np.ndarray, ids: np.ndarray, dists: np.ndarray,
          n_due: int, block: int = 8192) -> Dict[str, float]:
    """The four numbers for answers ``ids``/``dists`` (A, k) to the pool
    queries ``qidx`` (A,); ``x`` (n, d) and ``q`` (Q, d) on the device the
    reference runs on, ``gt`` (Q, k) its exact ids."""
    n, k = x.shape[0], gt.shape[1]
    dev = x.device
    bad = 0
    worst = 0.0
    hits = 0
    for s in range(0, len(qidx), block):
        qi = torch.from_numpy(np.asarray(qidx[s:s + block], np.int64)).to(dev)
        a_ids = torch.from_numpy(np.asarray(ids[s:s + block], np.int64)).to(dev)
        a_d = torch.from_numpy(np.asarray(dists[s:s + block],
                                          np.float32)).to(dev)
        in_range = ((a_ids >= 0) & (a_ids < n)).all(1)
        srt = torch.sort(a_ids, dim=1).values
        distinct = (srt[:, 1:] != srt[:, :-1]).all(1)
        finite = torch.isfinite(a_d).all(1)
        ascending = (a_d[:, 1:] >= a_d[:, :-1]).all(1)
        ok = in_range & distinct & finite & ascending
        bad += int((~ok).sum())
        if bool(ok.any()):
            rows = ok.nonzero().flatten()
            d64, scale = reference.pair_dists64(x, q[qi[rows]], a_ids[rows])
            gap = (a_d[rows].double() - d64).abs() / scale.clamp_min(1e-30)
            worst = max(worst, float(gap.max()))
        g = gt[qi]
        hits += int((a_ids[:, :, None] == g[:, None, :]).any(2).sum())
    answered = len(qidx)
    recall = hits / (max(answered, 1) * k)
    return {"missing": float(n_due - answered), "bad_rows": float(bad),
            "dist_err": worst, "recall_miss": 1.0 - recall}


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` in a fixed order, for the result's
    last key and the last lines of standard error."""
    return {name: {"value": readings[name], "limit": float(limits[name])}
            for name in ORDER}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
