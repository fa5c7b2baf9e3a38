"""Whole runs of the harness on the CPU at a tiny size: the result line,
the open loop's clock, the refusal without a card, the imports, a cell
added as new files only, and the check catching each fault of the timed
path."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pilotbench import drivers, harness, manifest
from pilotbench.tests.tiny import REPO, make_root

CPU = torch.device("cpu")
SECONDS = 0.5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, trace=False, seed=2 ** 31 + 17):
    return harness.run_cell(root, cell, seed, SECONDS, trace, CPU,
                            time.perf_counter())


def test_last_line_keys_and_checks(root):
    out = run(root, "tiny.search")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0 and out["attempted"] % 16 == 0
    assert set(out["metrics"]) == {"setup_s", "qps", "recall_at_10"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(out["checks"]) == ["missing", "bad_rows", "dist_err",
                                   "recall_miss"]
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)


def test_traced_serve_run_reports_its_per_layer_metrics(root):
    out = run(root, "tiny.serve", trace=True)
    assert out["correct"] is True
    assert {"engine.rows_per_batch", "engine.max_gap_ms"} <= set(
        out["metrics"])
    assert "p95_ms" not in out["metrics"]           # end-to-end: trace 0
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"


class _Req:
    def __init__(self, q):
        self.q, self.state, self.result = q, "pending", None

    @property
    def terminal(self):
        return self.state != "pending"


class _StallingEngine:
    """Completes everything pending at each pump, but stalls for
    ``stall`` seconds at the first pump after ``at`` seconds."""

    def __init__(self, at, stall, k):
        self.at, self.stall, self.k = at, stall, k
        self.pending, self.t0, self.stalled = [], None, False
        self.stats = {"batches": 0, "completed": 0}

    def submit(self, q):
        r = _Req(q)
        self.pending.append(r)
        return r

    def pump(self):
        self.t0 = self.t0 or time.perf_counter()
        if not self.stalled and time.perf_counter() - self.t0 > self.at:
            self.stalled = True
            time.sleep(self.stall)
        if not self.pending:
            return False
        for r in self.pending:
            r.state, r.result = "completed", (np.arange(self.k),
                                              np.zeros(self.k, np.float32))
        self.stats["batches"] += 1
        self.stats["completed"] += len(self.pending)
        self.pending = []
        return True


def test_open_loop_times_each_request_from_its_due_time():
    sut = SimpleNamespace(index=None, params=SimpleNamespace(k=4),
                          device=CPU)
    pool = np.zeros((64, 8), np.float32)
    d = drivers.load(REPO, "open_poisson")(
        sut, pool, {"kind": "open_poisson", "rate": 400.0}, seed=5)
    d.eng = _StallingEngine(at=0.2, stall=0.3, k=4)
    w = d.run(1.0)
    assert w.n_due == len(w.qidx) > 200
    lat = w.done_t - w.due_t
    assert bool((lat >= 0).all())
    # requests due while the engine stalled were sent late, and waited
    # from their due time, not from when they were sent
    during = (w.due_t > 0.25) & (w.due_t < 0.45)
    assert during.any()
    assert bool((w.done_t[during] >= 0.5 - 0.02).all())
    assert float(lat[during].max()) > 0.2
    assert w.late_s > 0.2
    assert drivers.max_gap_s(w.done_t, w.seconds) > 0.25


def test_arrivals_repeat_with_the_seed():
    sut = SimpleNamespace(index=None, params=SimpleNamespace(k=4),
                          device=CPU)
    mk = lambda seed: drivers.load(REPO, "open_poisson")(
        sut, np.zeros((8, 2)), {"kind": "open_poisson", "rate": 1000.0},
        seed)
    a, b, c = (mk(s).arrivals(2.0, 0) for s in (2 ** 33, 2 ** 33, 7))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.max() < 2.0 and 1800 < len(a) < 2200


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "deep1m.search.b128", "--seed", "1",
                       "--seconds", "1"], time.perf_counter())
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_the_command_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "pilotbench/run.py", "--workload",
                        "deep1m.search.b128", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    code = ("import sys, time, torch\n"
            "from pilotbench import harness\n"
            f"harness.run_cell({str(root)!r}, 'tiny.search', 3, 0.2, True, "
            "torch.device('cpu'), time.perf_counter())\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO / 'src'}")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "reprox.core", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()


REVERSED_DRIVER = """
from pathlib import Path

import numpy as np

from pilotbench import drivers

Base = drivers.load(Path(__file__).parents[2], "closed_batch")


class Driver(Base):
    \"\"\"closed_batch with the pool's batches sent last to first.\"\"\"

    def _one(self, spans=False):
        self.next = (self.next - 2) % self.n_batches
        return super()._one(spans)
"""


def test_a_cell_added_as_new_files_only(tmp_path):
    """A configuration, a traffic mix with a driver of a new kind, a metric
    and a cell: new files and new entries, no file edited."""
    r = make_root(tmp_path)
    b = r / "pilotbench"
    cfg = json.loads((b / "configs" / "tiny.json").read_text())
    cfg["name"] = "tiny48"
    cfg["data"].update(d=48)
    (b / "configs" / "tiny48.json").write_text(json.dumps(cfg))
    (b / "drivers" / "closed_batch_reversed.py").write_text(REVERSED_DRIVER)
    (b / "traffic" / "search.b8.json").write_text(json.dumps(
        {"kind": "closed_batch_reversed", "batch": 8, "warm_seconds": 0.0}))
    (b / "metrics" / "batches.py").write_text(
        "def read(run):\n    return len(run.window.batch_stats)\n")
    man = json.loads((r / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny48", "source": "a test size",
                           "file": "pilotbench/configs/tiny48.json",
                           "reduced": ["n"], "why": "a new configuration"})
    man["workloads"].append({"name": "tiny48.search.b8", "config": "tiny48",
                             "traffic": "search.b8", "chips": 1,
                             "why": "a new cell"})
    man["per_layer"].append({"name": "batches", "unit": "batches",
                             "better": "higher", "source": "program_counter",
                             "layer": "the test", "moves": "setup_s",
                             "workloads": ["tiny48.search.b8"]})
    (r / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.problems(man, r) == []
    out = harness.run_cell(r, "tiny48.search.b8", 9, 0.3, True, CPU,
                           time.perf_counter())
    assert out["correct"] is True
    assert out["metrics"]["batches"]["value"] >= 1


def test_a_mix_of_a_kind_with_no_driver_file_is_caught(tmp_path):
    r = make_root(tmp_path)
    (r / "pilotbench" / "traffic" / "search.tiny.json").write_text(
        json.dumps({"kind": "closed_batch_v2", "batch": 16}))
    man = json.loads((r / "BENCHMARK.json").read_text())
    assert any("no driver file" in p for p in manifest.problems(man, r))
    with pytest.raises(ValueError, match="no driver file"):
        harness.run_cell(r, "tiny.search", 9, 0.3, False, CPU,
                         time.perf_counter())


# -- faults of the timed path: each has to make `correct` false -------------

def _search_fault(kind):
    from repro_torch.core.engine import PilotANNIndex
    orig = PilotANNIndex.search
    last = {}

    def faulty(self, queries, params, **kw):
        if kind == "half":                  # half the batch left out
            queries = np.array(queries, copy=True)
            queries[len(queries) // 2:] = 0.0
        ids, dists, stats = orig(self, queries, params, **kw)
        if kind == "stale":                 # the state returned unchanged
            prev = last.get("out")
            last["out"] = (ids, dists, stats)
            if prev is not None:
                return prev
        if kind == "altered":               # an answer altered
            ids = ids.copy()
            ids[:, -1] = (ids[:, -1] + 1) % self.n
        return ids, dists, stats
    return PilotANNIndex, "search", faulty


def _engine_fault(kind):
    from repro_torch.core import pipeline
    orig = pipeline._Stages.cpu
    last = {}

    def faulty(self, queries, *rest):
        if kind == "half":
            queries = queries.clone()
            queries[queries.shape[0] // 2:] = 0.0
        ids, dists = orig(self, queries, *rest)
        if kind == "stale":
            prev = last.get(queries.shape[0])
            last[queries.shape[0]] = (ids, dists)
            if prev is not None:
                return prev
        if kind == "altered":
            ids = ids.clone()
            ids[:, -1] = (ids[:, -1] + 1) % (self.arrays["rot_vecs"].shape[0]
                                             - 1)
        return ids, dists
    return pipeline._Stages, "cpu", faulty


@pytest.mark.parametrize("cell", ["tiny.search", "tiny.serve"])
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_a_fault_of_the_timed_path_is_not_correct(root, monkeypatch, cell,
                                                  fault):
    mk = _search_fault if cell == "tiny.search" else _engine_fault
    owner, attr, faulty = mk(fault)
    monkeypatch.setattr(owner, attr, faulty)
    out = run(root, cell, seed=2 ** 31 + 99)
    assert out["correct"] is False, out["checks"]
