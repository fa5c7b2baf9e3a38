"""The readers of the program's own counters and stage timings, on the CPU
at a tiny size: the engine's split of a request's latency reads numbers,
the stage timings (CUDA graphs' events) read nothing, the retired host
tests' reader is gone, and the manifest with their entries meets the
contract.  The
stage readers' arithmetic, and their refusal of a window that dropped a
timing, on counters given by hand."""

import time
from types import SimpleNamespace

import pytest
import torch

from pilotbench import harness, manifest
from pilotbench.tests.tiny import REPO, make_root

STAGE_READERS = [f"stage{i}.device_ms_per_batch" for i in range(4)]
ENGINE_READERS = ["engine.queued_ms", "engine.in_flight_ms",
                  "engine.drain_ms"]
# retired: since the search is one CUDA graph a batch, its counter stays 0
RETIRED = "search.host_tests_per_batch"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def traced(root, cell):
    return harness.run_cell(root, cell, 2 ** 31 + 29, 0.5, True,
                            torch.device("cpu"), time.perf_counter())


def test_the_manifest_with_the_new_entries_meets_the_contract():
    man = manifest.load(REPO)
    names = {m["name"] for m in man["per_layer"]}
    assert set(STAGE_READERS + ENGINE_READERS) <= names
    assert RETIRED not in names
    assert not manifest.metric_file(REPO, RETIRED).exists()
    assert manifest.problems(man, REPO) == []


def test_search_cell_reads_no_stage_time_and_no_host_tests(root):
    out = traced(root, "tiny.search")
    assert out["correct"] is True
    m = out["metrics"]
    for name in STAGE_READERS + [RETIRED]:
        assert name not in m, name


def test_serve_cell_reads_the_engine_split(root):
    out = traced(root, "tiny.serve")
    assert out["correct"] is True
    m = out["metrics"]
    for name in ENGINE_READERS:
        assert m[name]["value"] >= 0 and m[name]["unit"] == "ms", name
    assert m["engine.queued_ms"]["value"] > 0
    assert m["engine.drain_ms"]["value"] > 0
    for name in STAGE_READERS + [RETIRED]:
        assert name not in m, name


@pytest.mark.parametrize("name", STAGE_READERS)
def test_stage_reader_reads_ms_a_batch_unless_a_timing_was_dropped(name):
    read = harness.load_reader(REPO, name)
    stage = name.split(".")[0]

    def window(**launches):
        return SimpleNamespace(window=SimpleNamespace(batches=4,
                                                      launches=launches))

    counters = {f"{stage}.device_ns": 6_000_000, "trace.readings_dropped": 0}
    assert read(window(**counters)) == 1.5
    counters["trace.readings_dropped"] = 1
    assert read(window(**counters)) is None
    assert read(window(**{f"{stage}.device_ns": 0})) is None
