"""BENCHMARK.json against the benchmark's contract."""

import copy
import json

import pytest

from pilotbench import manifest
from pilotbench.tests.tiny import REPO


@pytest.fixture(scope="module")
def shipped():
    return manifest.load(REPO)


def test_shipped_manifest_meets_the_contract(shipped):
    assert manifest.problems(shipped, REPO) == []


def test_cells_and_metrics_are_the_ones_asked_for(shipped):
    assert [w["name"] for w in shipped["workloads"]] == [
        "deep1m.search.b128", "syn200.search.b128", "deep1m.serve.poisson"]
    assert all(w["chips"] == 1 for w in shipped["workloads"])
    e2e = {m["name"] for m in shipped["end_to_end"]}
    assert e2e == {"setup_s", "qps", "recall_at_10", "p95_ms",
                   "peak_mem_gib"}
    by = {m["name"]: m for m in shipped["end_to_end"]}
    assert by["setup_s"]["bound"] <= 0.25
    assert all(len(m["unit"]) <= 16 for m in shipped["end_to_end"]
               + shipped["per_layer"])


def test_every_per_layer_metric_moves_a_metric_its_cells_report(shipped):
    e2e = {m["name"]: m for m in shipped["end_to_end"]}
    for m in shipped["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert manifest.reports(e2e[m["moves"]], w), (m["name"], w)


def test_every_cell_reports_setup_another_e2e_and_a_layer(shipped):
    for w in shipped["workloads"]:
        e2e = [m["name"] for m in manifest.cell_metrics(shipped, w["name"],
                                                        False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.cell_metrics(shipped, w["name"], True)


def _broken(shipped, how):
    m = copy.deepcopy(shipped)
    if how == "long_unit":
        m["end_to_end"][1]["unit"] = "queries per second"
    elif how == "space_in_name":
        m["workloads"][0]["name"] = "deep1m search"
    elif how == "moves_unreported":
        m["per_layer"][0]["moves"] = "qps"
    elif how == "unknown_moves":
        m["per_layer"][0]["moves"] = "tokens_per_s"
    elif how == "loose_bound":
        m["end_to_end"][0]["bound"] = 0.3
    elif how == "no_traffic_file":
        m["workloads"][0]["traffic"] = "search.b64"
    elif how == "extra_key":
        m["end_to_end"][0]["why"] = "a metric may not carry a why"
    elif how == "no_setup":
        m["end_to_end"] = [x for x in m["end_to_end"]
                           if x["name"] != "setup_s"]
    elif how == "e2e_from_program":
        m["end_to_end"][1]["source"] = "program_counter"
    elif how == "no_reader":
        m["per_layer"][0]["name"] = "engine.queue_wait_ms"
    return m


@pytest.mark.parametrize("how", [
    "long_unit", "space_in_name", "moves_unreported", "unknown_moves",
    "loose_bound", "no_traffic_file", "extra_key", "no_setup",
    "e2e_from_program", "no_reader"])
def test_a_broken_manifest_is_caught(shipped, how):
    assert manifest.problems(_broken(shipped, how), REPO)


def test_configuration_files_hold_their_reduction(shipped):
    for c in shipped["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert set(cfg["limits"]) == {"missing", "bad_rows", "dist_err",
                                      "recall_miss"}
        assert cfg["limits"]["recall_miss"] == pytest.approx(
            1.0 - cfg["guarantees"]["recall_at_10"])
