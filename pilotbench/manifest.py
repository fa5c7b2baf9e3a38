"""``BENCHMARK.json``: loading it, finding a cell's files, and checking it
against the benchmark's contract (names, units, keys, and which cell
reports which metric).

The harness is driven by this file.  A cell names a configuration
(``configs[].file``) and a traffic mix (``<bench>/traffic/<traffic>.json``),
whose ``kind`` names its driver (``<bench>/drivers/<kind>.py``); every
metric, end-to-end or per-layer, is read by its own reader,
``<bench>/metrics/<name>.py``, where ``<bench>`` is the directory of the
harness (``pilotbench``).  Adding a configuration, a mix, a driver, a metric
or a cell adds files and entries and edits none.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List

BENCH_DIR = "pilotbench"
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config_entry(manifest: dict, name: str) -> dict:
    return next(c for c in manifest["configs"] if c["name"] == name)


def traffic_file(root: Path, traffic: str) -> Path:
    return Path(root) / BENCH_DIR / "traffic" / f"{traffic}.json"


def driver_file(root: Path, kind: str) -> Path:
    return Path(root) / BENCH_DIR / "drivers" / f"{kind}.py"


def metric_file(root: Path, metric: str) -> Path:
    return Path(root) / BENCH_DIR / "metrics" / f"{metric}.py"


def reports(metric: dict, cell_name: str) -> bool:
    """Does the cell report this metric (its ``workloads``, or every cell
    where it has none)?"""
    return cell_name in metric.get("workloads", [cell_name])


def cell_metrics(manifest: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell prints: end-to-end with ``--trace 0``,
    per-layer with ``--trace 1``."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind] if reports(m, cell_name)]


def _line(s, n: int = 200) -> bool:
    return (isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s
            and "\t" not in s)


def problems(manifest: dict, root: Path) -> List[str]:
    """Every way the manifest breaks the contract (empty when none)."""
    out: List[str] = []
    root = Path(root)
    if tuple(manifest) != TOP_KEYS and set(manifest) != set(TOP_KEYS):
        out.append(f"top-level keys {sorted(manifest)} != {sorted(TOP_KEYS)}")
    paths = manifest.get("paths", [])
    if not 1 <= len(paths) <= 16 or not all(
            PATH.match(p) and not p.startswith("/") and ".." not in p
            for p in paths):
        out.append(f"bad paths {paths}")
    cmd = manifest.get("command", [])
    if not 1 <= len(cmd) <= 32 or not all(_line(w) for w in cmd):
        out.append("bad command")
    rs = manifest.get("run_seconds")
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        out.append(f"run_seconds {rs} not a whole number in 1..51")
    names = set()

    def named(entry, what):
        n = entry.get("name")
        if not isinstance(n, str) or not NAME.match(n):
            out.append(f"{what} name {n!r} breaks the name rule")
        if n in names:
            out.append(f"name {n!r} used twice")
        names.add(n)

    configs = manifest.get("configs", [])
    if not 1 <= len(configs) <= 24:
        out.append("1 to 24 configs")
    for c in configs:
        named(c, "config")
        if set(c) != CONFIG_KEYS:
            out.append(f"config {c.get('name')}: keys {sorted(c)}")
        if not (_line(c.get("source")) and _line(c.get("why"))):
            out.append(f"config {c.get('name')}: source/why")
        red = c.get("reduced", [])
        if len(red) > 16 or not all(NAME.match(k) for k in red):
            out.append(f"config {c.get('name')}: reduced {red}")
        f = c.get("file", "")
        if not any(f.startswith(p.rstrip("/") + "/") for p in paths):
            out.append(f"config {c.get('name')}: file {f} not under paths")
        elif not (root / f).is_file():
            out.append(f"config {c.get('name')}: no file {f}")
    cells = manifest.get("workloads", [])
    if not 1 <= len(cells) <= 24:
        out.append("1 to 24 workloads")
    pairs = set()
    for w in cells:
        named(w, "workload")
        if set(w) != CELL_KEYS:
            out.append(f"workload {w.get('name')}: keys {sorted(w)}")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}: chips {w.get('chips')}")
        if not _line(w.get("why")):
            out.append(f"workload {w.get('name')}: why")
        if w.get("config") not in {c.get("name") for c in configs}:
            out.append(f"workload {w.get('name')}: unknown config")
        t = w.get("traffic", "")
        if not NAME.match(t) or not traffic_file(root, t).is_file():
            out.append(f"workload {w.get('name')}: no traffic file for {t!r}")
        else:
            kind = json.loads(traffic_file(root, t).read_text()).get("kind")
            if not NAME.match(str(kind)) or \
                    not driver_file(root, kind).is_file():
                out.append(f"workload {w.get('name')}: no driver file for "
                           f"traffic kind {kind!r}")
        pair = (w.get("config"), t)
        if pair in pairs:
            out.append(f"workload {w.get('name')}: pair {pair} twice")
        pairs.add(pair)
    four = sum(w.get("chips") == 4 for w in cells)
    if four > max(1, len(cells) // 4):
        out.append(f"{four} cells on 4 chips")
    used = {w.get("config") for w in cells}
    for c in configs:
        if c.get("name") not in used:
            out.append(f"config {c.get('name')} used by no cell")
    cell_names = {w.get("name") for w in cells}
    e2e = manifest.get("end_to_end", [])
    layer = manifest.get("per_layer", [])
    if not 1 <= len(e2e) <= 16 or not 1 <= len(layer) <= 128:
        out.append("1 to 16 end-to-end and 1 to 128 per-layer metrics")
    for m, keys, what in ([(m, E2E_KEYS, "end_to_end") for m in e2e]
                          + [(m, LAYER_KEYS, "per_layer") for m in layer]):
        named(m, what)
        extra = set(m) - keys - {"workloads"}
        if set(m) - {"workloads"} != keys:
            out.append(f"{what} {m.get('name')}: keys {sorted(m)} "
                       f"(extra {sorted(extra)})")
        if not UNIT.match(str(m.get("unit", ""))):
            out.append(f"{what} {m.get('name')}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"{what} {m.get('name')}: better")
        allowed = (("host_clock", "device_trace") if what == "end_to_end"
                   else SOURCES)
        if m.get("source") not in allowed:
            out.append(f"{what} {m.get('name')}: source {m.get('source')}")
        if not set(m.get("workloads", [])) <= cell_names:
            out.append(f"{what} {m.get('name')}: unknown workloads")
        if not metric_file(root, m.get("name", "")).is_file():
            out.append(f"{what} {m.get('name')}: no reader file")
    for m in e2e:
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            out.append(f"end_to_end {m.get('name')}: bound {b}")
    e2e_names = {m.get("name") for m in e2e}
    if "setup_s" not in e2e_names:
        out.append("no setup_s")
    for m in layer:
        if not _line(m.get("layer")):
            out.append(f"per_layer {m.get('name')}: layer")
        mv = m.get("moves")
        if mv not in e2e_names:
            out.append(f"per_layer {m.get('name')}: moves {mv!r}")
            continue
        mv_metric = next(x for x in e2e if x.get("name") == mv)
        for w in cell_names:
            if reports(m, w) and not reports(mv_metric, w):
                out.append(f"per_layer {m.get('name')}: cell {w} does not "
                           f"report {mv}")
    for w in cell_names:
        rep = [m.get("name") for m in e2e if reports(m, w)]
        if "setup_s" not in rep or len(rep) < 2:
            out.append(f"cell {w}: needs setup_s and another end-to-end")
        if not any(reports(m, w) for m in layer):
            out.append(f"cell {w}: no per-layer metric")
    if len(json.dumps(manifest).encode()) > 64 * 1024:
        out.append("over 64 KiB")
    return out
