"""The mutable cell on the CPU at a tiny size: a whole run over
``SegmentedIndex`` with the churn on, the live-set check against faults of
the write path (each has to make ``correct`` false through the numbers of
a changing corpus), the churn-free run judged alike by both checks, the
held-back rows, and the mutation log's clock."""

import json
import time

import numpy as np
import pytest
import torch

from pilotbench import check, harness, vectors
from pilotbench.drivers import MutationLog, Window
from pilotbench.tests.tiny import CHURN, make_root, tiny_mutable_config

CPU = torch.device("cpu")
SECONDS = 0.5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell="tiny.mutable", trace=False, seed=2 ** 31 + 41):
    return harness.run_cell(root, cell, seed, SECONDS, trace, CPU,
                            time.perf_counter())


def test_mutable_run_is_correct_and_reports_its_metrics(root):
    out = run(root)
    assert out["correct"] is True, out["checks"]
    assert list(out["checks"]) == list(check.ORDER)
    assert out["checks"]["dead_ids"]["value"] == 0
    assert set(out["metrics"]) == {"setup_s", "recall_at_10", "p95_ms"}
    assert list(out)[-1] == "checks"


def test_traced_mutable_run_reads_the_mutation_drain(root):
    out = run(root, trace=True, seed=2 ** 31 + 43)
    assert out["correct"] is True, out["checks"]
    m = out["metrics"]
    assert 0 < m["engine.mutation_pct"]["value"]
    assert m["engine.mutation_pct"]["unit"] == "%"
    for name in ("engine.rows_per_batch", "engine.max_gap_ms",
                 "engine.queued_ms", "engine.in_flight_ms",
                 "engine.drain_ms"):
        assert name in m, name


# -- faults of the write path: each has to make `correct` false -------------

def _deletes_acknowledged_not_applied(monkeypatch):
    from repro_torch.core.segments import SegmentedIndex
    monkeypatch.setattr(SegmentedIndex, "delete",
                        lambda self, gids: len(np.atleast_1d(gids)))


def _upserts_never_searchable(monkeypatch):
    from repro_torch.core.segments import SegmentedIndex

    def insert(self, vecs):
        b = len(np.atleast_2d(vecs))
        gids = np.arange(self._next_gid, self._next_gid + b)
        self._next_gid += b
        self._gid_dead = np.concatenate([self._gid_dead, np.zeros(b, bool)])
        return gids
    monkeypatch.setattr(SegmentedIndex, "insert", insert)


def _stale_answers(monkeypatch):
    """Each merged answer is the one the previous batch of its bucket got:
    the answer of an index as it stood before."""
    from repro_torch.core.segments import SegmentedIndex
    orig = SegmentedIndex.merge_with_deltas
    last = {}

    def merge(self, q_rot, *rest):
        out = orig(self, q_rot, *rest)
        prev = last.get(q_rot.shape[0])
        last[q_rot.shape[0]] = out
        return out if prev is None else prev
    monkeypatch.setattr(SegmentedIndex, "merge_with_deltas", merge)


@pytest.mark.parametrize("fault, number", [
    (_deletes_acknowledged_not_applied, "dead_ids"),
    (_upserts_never_searchable, "unread_writes"),
    (_stale_answers, "unread_writes")])
def test_a_fault_of_the_write_path_is_not_correct(root, monkeypatch, fault,
                                                  number):
    fault(monkeypatch)
    out = run(root, seed=2 ** 31 + 97)
    c = out["checks"]
    assert out["correct"] is False, c
    assert c[number]["value"] > c[number]["limit"], c


def test_unsearchable_upserts_cost_recall_against_the_live_set(root,
                                                               monkeypatch):
    sound = run(root, seed=2 ** 31 + 98)["checks"]["recall_miss"]["value"]
    _upserts_never_searchable(monkeypatch)
    c = run(root, seed=2 ** 31 + 98)["checks"]
    assert c["unread_writes"]["value"] == 1.0
    assert c["recall_miss"]["value"] > sound


# -- the churn-free run: the live-set check and the old one agree -----------

def test_a_churn_free_run_reads_alike_by_both_checks(tmp_path, monkeypatch):
    r = make_root(tmp_path)
    (r / "pilotbench" / "traffic" / "serve.churn.json").write_text(
        json.dumps(dict(CHURN, period_s=1e3, preload_periods=0)))
    seen = {}
    judge = harness.judge

    def keep(cfg, x, q, w, device):
        seen.update(cfg=cfg, x=x, q=q, w=w)
        return judge(cfg, x, q, w, device)
    monkeypatch.setattr(harness, "judge", keep)
    out = run(r, seed=2 ** 31 + 45)
    assert out["correct"] is True, out["checks"]
    w, x, q = seen["w"], seen["x"], seen["q"]
    assert w.mutations is not None and not w.mutations.kinds
    n = seen["cfg"]["data"]["n"]
    xd, qd = torch.from_numpy(x[:n]), torch.from_numpy(q)
    gt, _ = harness.reference.exact_knn(xd, qd, 10)
    old = check.judge(xd, qd, gt, w.qidx, w.ids, w.dists, w.n_due)
    live = check.judge_live(torch.from_numpy(x), qd, w, 10)
    assert {k: live[k] for k in old} == old
    assert {k: out["checks"][k]["value"] for k in old} == old
    assert live["dead_ids"] == 0 and live["unread_writes"] == 0


# -- the live-set check on answers given by hand ----------------------------

def _window(x, qidx, ids, submit, done, log):
    ids = np.asarray(ids, np.int64)
    d = ((x[ids] - QUERIES[qidx][:, None, :]) ** 2).sum(-1)
    return Window(seconds=1.0, n_due=len(qidx), qidx=np.asarray(qidx),
                  ids=ids, dists=d.astype(np.float32),
                  due_t=np.asarray(submit, float),
                  done_t=np.asarray(done, float), launches={},
                  open_loop=True, batches=1,
                  submit_t=np.asarray(submit, float), mutations=log)


X = np.arange(40, dtype=np.float32).reshape(10, 4) ** 0.5
QUERIES = X[[0, 9]] + 0.01


def test_live_set_by_submit_time():
    """Rows 0-8 are the base, 9 held back: 9 upserted at t 1, 0
    deleted at t 2.  The query next to row 9 submitted at 1.5 must find
    it; the one next to row 0 submitted at 2.5 must not return 0."""
    log = MutationLog(n_base=9, kinds=["insert", "delete"],
                      ids=[np.array([9]), np.array([0])],
                      done_t=np.array([1.0, 2.0]))
    xd, qd = torch.from_numpy(X), torch.from_numpy(QUERIES)
    ok = _window(X, [1, 0], [[9, 8], [1, 2]], [1.5, 2.5], [1.6, 2.6], log)
    r = check.judge_live(xd, qd, ok, 2)
    assert r["dead_ids"] == 0 and r["bad_rows"] == 0
    assert r["recall_miss"] == 0
    # row 0 after its delete: a dead id
    dead = _window(X, [0], [[0, 1]], [2.5], [2.6], log)
    assert check.judge_live(xd, qd, dead, 2)["dead_ids"] == 1
    # before its delete: live, and the right answer
    before = _window(X, [0], [[0, 1]], [1.9], [2.6], log)
    r = check.judge_live(xd, qd, before, 2)
    assert r["dead_ids"] == 0 and r["recall_miss"] == 0
    # row 9 before its upsert: not the live set's answer, but assigned
    # by the answer's completion, so neither dead nor bad
    early = _window(X, [1], [[9, 8]], [0.5], [1.5], log)
    r = check.judge_live(xd, qd, early, 2)
    assert r["dead_ids"] == 0 and r["bad_rows"] == 0
    assert r["recall_miss"] == 0.5
    # an id not yet assigned when the answer completed: dead and bad
    unassigned = _window(X, [1], [[9, 8]], [0.5], [0.9], log)
    r = check.judge_live(xd, qd, unassigned, 2)
    assert r["dead_ids"] == 1 and r["bad_rows"] == 1


def test_a_read_back_must_return_its_row_unless_deleted_first():
    log = MutationLog(n_base=9, kinds=["insert", "delete"],
                      ids=[np.array([9]), np.array([9])],
                      done_t=np.array([1.0, 3.0]))
    xd = torch.from_numpy(X)
    qd = torch.from_numpy(np.concatenate([QUERIES, X[[9]]]))
    w = _window(X, [1], [[9, 8]], [1.5], [1.6], log)
    w.qidx, w.reads_back = np.array([2]), np.array([9])
    assert check.judge_live(xd, qd, w, 2)["unread_writes"] == 0
    w.ids = np.array([[8, 7]])
    assert check.judge_live(xd, qd, w, 2)["unread_writes"] == 1
    w.done_t = np.array([3.5])          # deleted before it completed
    assert check.judge_live(xd, qd, w, 2)["unread_writes"] == 0


def test_held_back_rows_follow_the_base():
    data = dict(tiny_mutable_config()["data"])
    x, q = vectors.make_dataset(data, 2 ** 31 + 7)
    assert x.shape == (data["n"] + data["n_insert"], data["d"])
    want = vectors.synthetic_vectors(
        data["n"] + data["n_insert"], data["d"], n_queries=data["n_queries"],
        seed=2 ** 31 + 7, spectral_decay=data["spectral_decay"])
    assert x.tobytes() == want[0].tobytes() and q.tobytes() == want[1]\
        .tobytes()
