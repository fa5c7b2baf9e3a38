"""A benchmark root at a size the CPU tests can run: the repository's
metric readers, drivers and ``BENCHMARK.json``'s metrics, with two tiny
configurations (the deep1m file's shape and limits at n 2,000, and the
deep1m-mutable file's with 1,024 rows held back) and three tiny mixes of
the shipped kinds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "pilotbench"


def tiny_config() -> dict:
    cfg = json.loads((BENCH / "configs" / "deep1m.json").read_text())
    cfg["name"] = "tiny"
    cfg["data"].update(n=2000, n_queries=256)
    cfg["index"].update(n_entry=256)
    return cfg


def tiny_mutable_config() -> dict:
    """deep1m-mutable at n 2,000 with 1,024 rows held back."""
    cfg = json.loads((BENCH / "configs" / "deep1m-mutable.json").read_text())
    cfg["name"] = "tiny-mutable"
    cfg["data"].update(n=2000, n_insert=1024, n_queries=256)
    cfg["index"].update(n_entry=256)
    return cfg


# the entry of the mutation drain's reader, for the mutable cell
MUTATION_PCT = {"name": "engine.mutation_pct", "unit": "%", "better": "lower",
                "source": "program_span",
                "layer": "serving/server.py ThroughputEngine mutation drain",
                "moves": "p95_ms", "workloads": ["tiny.mutable"]}

CHURN = {"kind": "open_churn", "rate": 40.0,
         "serve": {"depth": 2, "donate": True, "use_semantic_cache": False,
                   "mutations_per_pump": 16},
         "period_s": 0.1, "rows": 16, "preload_periods": 10,
         "warm_seconds": 0.3, "trace_seconds": 0.3}


def make_root(tmp: Path, rate: float = 40.0) -> Path:
    """``tmp`` set up as a benchmark root; cells ``tiny.search`` (closed
    loop, batches of 16), ``tiny.serve`` (open loop at ``rate``) and
    ``tiny.mutable`` (``CHURN``: the open loop over the mutable
    configuration, 16-row upserts every 0.1 s and deletes between)."""
    tmp = Path(tmp)
    b = tmp / "pilotbench"
    keep = shutil.ignore_patterns("__pycache__")
    shutil.copytree(BENCH / "metrics", b / "metrics", ignore=keep)
    shutil.copytree(BENCH / "drivers", b / "drivers", ignore=keep)
    (b / "configs").mkdir(parents=True)
    (b / "traffic").mkdir()
    (b / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (b / "configs" / "tiny-mutable.json").write_text(
        json.dumps(tiny_mutable_config()))
    (b / "traffic" / "serve.churn.json").write_text(json.dumps(CHURN))
    (b / "traffic" / "search.tiny.json").write_text(json.dumps(
        {"kind": "closed_batch", "batch": 16, "warm_seconds": 0.0,
         "trace_batches": 2}))
    (b / "traffic" / "serve.tiny.json").write_text(json.dumps(
        {"kind": "open_poisson", "rate": rate,
         "serve": {"depth": 2, "donate": True, "use_semantic_cache": False},
         "warm_seconds": 0.3, "trace_seconds": 0.3}))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man["configs"] = [{"name": "tiny", "source": "a test size",
                       "file": "pilotbench/configs/tiny.json",
                       "reduced": ["n"], "why": "CPU tests"},
                      {"name": "tiny-mutable", "source": "a test size",
                       "file": "pilotbench/configs/tiny-mutable.json",
                       "reduced": ["n"], "why": "CPU tests"}]
    cells = {"closed_batch": "tiny.search", "open_poisson": "tiny.serve"}
    man["workloads"] = [
        {"name": "tiny.search", "config": "tiny", "traffic": "search.tiny",
         "chips": 1, "why": "closed loop"},
        {"name": "tiny.serve", "config": "tiny", "traffic": "serve.tiny",
         "chips": 1, "why": "open loop"},
        {"name": "tiny.mutable", "config": "tiny-mutable",
         "traffic": "serve.churn", "chips": 1, "why": "open loop, churn"}]
    kind = {w["name"]: json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                                  .read_text())["kind"]
            for w in json.loads((REPO / "BENCHMARK.json").read_text())
            ["workloads"]}
    for sec in ("end_to_end", "per_layer"):
        for m in man[sec]:
            if "workloads" in m:
                m["workloads"] = sorted({cells[kind[w]]
                                         for w in m["workloads"]})
            # the mutable cell reports what the serve cell reports
            if "tiny.serve" in m.get("workloads", []):
                m["workloads"].append("tiny.mutable")
    man["per_layer"].append(MUTATION_PCT)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return tmp
