"""One run of one cell: set-up, the measured window, an optional traced
window, the check against the plain reference, and the result line.

A run, in order:

1. makes the configuration's vectors and queries from ``--seed``
   (``vectors.py``), builds the port's index over them (over the first
   ``n``, where the configuration holds ``n_insert`` rows back for the
   driver to insert) and lets the traffic's driver warm up what it will
   use (``drivers/<kind>.py``): that is ``setup_s``, counted from the
   start of the process;
2. drives the window for ``--seconds`` and keeps every answer;
3. with ``--trace 1``, drives a short traced window of the same traffic;
4. reads the device's memory peak, frees the program's state, and judges
   every answer of the window against the exact reference
   (``check.py``, ``reference.py``): over the rows live at each request's
   submit where the driver changed the corpus;
5. reads the cell's metrics, each with its own reader
   (``metrics/<name>.py``), and prints the result as the last line of
   standard output, the compared numbers last on standard error.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from pilotbench import check, drivers, manifest, reference, system, vectors
from pilotbench.trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
STRETCH_S = 5.0      # the window's stretches that the log reports apart


def log(msg: str) -> None:
    print(f"[pilotbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class SUT:
    """The system under test as the drivers use it, and the rows held back
    for the driver to insert (``data.n_insert``; none where there are
    none)."""
    index: Any
    params: Any
    device: torch.device
    held: Optional[np.ndarray] = None


@dataclass
class Run:
    """Everything a metric's reader may read."""
    cell: dict
    cfg: dict
    traffic: dict
    device_name: str
    setup_s: float = 0.0
    shapes: Dict[str, int] = field(default_factory=dict)
    search: Dict[str, Any] = field(default_factory=dict)
    window: Optional[drivers.Window] = None
    trace: Optional[Trace] = None
    trace_window: Optional[drivers.Window] = None
    peak_window_bytes: Optional[int] = None
    readings: Dict[str, float] = field(default_factory=dict)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_reader(root: Path, name: str):
    path = manifest.metric_file(root, name)
    spec = importlib.util.spec_from_file_location(
        f"pilotbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def index_shapes(index) -> Dict[str, int]:
    """Sizes of the index's tables that the byte arithmetic needs (a
    mutable index's are its base's)."""
    index = getattr(index, "base", index)
    A = index.arrays
    prim, nbr, fes_e = A["primary"], A["sub_neighbors"], A["fes_entries"]
    return {"dp": int(index.reducer.d_primary),
            "pilot_row_bytes": int(prim.shape[1] * prim.element_size()),
            "R": int(nbr.shape[1]), "id_bytes": int(nbr.element_size()),
            "fes_r": int(fes_e.shape[0]), "fes_C": int(fes_e.shape[1]),
            "fes_row_bytes": int(fes_e.shape[2] * fes_e.element_size()),
            "n": int(index.n), "d": int(index.d)}


def by_stretch(w: drivers.Window) -> list:
    """Answers a second and the 95th percentile of latency (ms) of the
    requests due in each ``STRETCH_S`` seconds of the window: how steady
    the window was inside."""
    out = []
    for a in np.arange(0.0, max(w.seconds, STRETCH_S), STRETCH_S):
        sel = (w.due_t >= a) & (w.due_t < a + STRETCH_S)
        if sel.any():
            lat = 1e3 * (w.done_t[sel] - w.due_t[sel])
            out.append([round(float(sel.sum()) / STRETCH_S, 1),
                        round(float(np.percentile(lat, 95)), 3)])
    return out


def judge(cfg: dict, x: np.ndarray, q: np.ndarray, w: drivers.Window,
          device: torch.device) -> Dict[str, float]:
    """The check's readings for the answers of ``w``: over the first ``n``
    rows, or, where the driver changed the corpus, over the rows live at
    each request's submit (``check.judge_live``)."""
    k = int(cfg["search"].get("k", 10))
    live = w.mutations is not None
    if not live:
        x = x[:int(cfg["data"]["n"])]
    elif w.queries is not None:
        q = np.concatenate([q, w.queries])
    xd, qd = torch.from_numpy(x).to(device), torch.from_numpy(q).to(device)
    if live:
        return check.judge_live(xd, qd, w, k)
    gt, _ = reference.exact_knn(xd, qd, k)
    return check.judge(xd, qd, gt, w.qidx, w.ids, w.dists, w.n_due)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float) -> dict:
    """One run of the cell on ``device`` (``cuda`` from the command line;
    the tests use the CPU); returns the result line as a dict."""
    root = Path(root)
    man = manifest.load(root)
    cell = manifest.cell(man, cell_name)
    cfg = json.loads((root / manifest.config_entry(
        man, cell["config"])["file"]).read_text())
    traffic = json.loads(manifest.traffic_file(root,
                                               cell["traffic"]).read_text())
    card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if card else "cpu"
    run = Run(cell=cell, cfg=cfg, traffic=traffic, device_name=name)

    # -- 1. set-up --------------------------------------------------------
    x, q = vectors.make_dataset(cfg["data"], seed)
    log(f"data {x.shape} + {q.shape} queries at "
        f"{time.perf_counter() - t_start:.1f} s")
    if card:
        system.build_kernels()
        log(f"kernels ready at {time.perf_counter() - t_start:.1f} s")
    n = int(cfg["data"]["n"])
    t = time.perf_counter()
    index = system.build_index(cfg, x[:n], device)
    base = getattr(index, "base", index)
    log(f"index built in {time.perf_counter() - t:.1f} s, by part "
        f"{json.dumps(base.build_seconds)}; memory_report "
        f"{json.dumps(base.memory_report())}")
    del base
    params = system.search_params(cfg)
    run.search = dataclasses.asdict(params)
    run.shapes = index_shapes(index)
    sut = SUT(index=index, params=params, device=device,
              held=x[n:] if len(x) > n else None)
    driver = drivers.make(root, sut, q, traffic, seed)
    driver.setup()
    if card:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
    gc.collect()
    gc.freeze()
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.2f} s")

    # -- 2. the window ----------------------------------------------------
    run.window = w = driver.run(seconds)
    if card:
        run.peak_window_bytes = torch.cuda.max_memory_allocated(device)
    log(f"window: {w.n_due} due, {len(w.qidx)} answered in "
        f"{w.seconds:.3f} s; engine {json.dumps(w.engine)}; sender late by "
        f"at most {1e3 * w.late_s:.2f} ms; launches "
        f"{json.dumps({k: v for k, v in w.launches.items() if v})}; by "
        f"5 s of the window: {json.dumps(by_stretch(w))}")

    # -- 3. the traced window ---------------------------------------------
    if trace:
        t = time.perf_counter()
        run.trace, run.trace_window = driver.trace()
        tw = run.trace_window
        log(f"traced window {run.trace.window_s:.4f} s, device busy "
            f"{run.trace.busy_s:.4f} s, {len(run.trace.device)} device ops, "
            f"{len(run.trace.host)} host events, {tw.batches} batches of "
            f"{len(tw.qidx) / max(tw.batches, 1):.1f} rows (window: "
            f"{w.batches} of {len(w.qidx) / max(w.batches, 1):.1f}); traced "
            f"and read in {time.perf_counter() - t:.1f} s")
    memory_peak = None
    if card:
        memory_peak = max(setup_peak, torch.cuda.max_memory_allocated(device))

    # -- 4. free the program's state, then check ---------------------------
    del driver, sut, index
    gc.unfreeze()
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    run.readings = judge(cfg, x, q, w, device)
    log(f"reference and check in {time.perf_counter() - t:.1f} s")

    # -- 5. metrics -------------------------------------------------------
    metrics = {}
    for m in manifest.cell_metrics(man, cell_name, trace):
        value = load_reader(root, m["name"])(run)
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = check.verdict(run.readings, cfg["limits"])
    dev = {"platform": "gpu" if card else "cpu", "kind": name,
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(memory_peak or 0)}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    out = {"correct": check.is_correct(checks), "attempted": int(w.n_due),
           "failed": int(run.readings["missing"]), "metrics": metrics,
           "device": dev}
    if trace:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    try:
        system.check_program()
    except ImportError as exc:
        log(f"the program (repro_torch under src/) is not importable from "
            f"{root}: {exc}; no result")
        return 5
    man = manifest.load(root)
    cell = manifest.cell(man, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"needs {cell['chips']} CUDA device(s), found {n}: no result "
            f"(there is no CPU fallback)")
        return 3
    log(f"{args.workload} seed {args.seed} seconds {args.seconds} trace "
        f"{args.trace} | {power_limit()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        log(f"modules of the JAX package or JAX were loaded: {bad}")
        return 4
    for n_, c in out["checks"].items():
        print(f"check {n_} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
