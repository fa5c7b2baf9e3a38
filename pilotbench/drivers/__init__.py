"""The general traffic generator.  A mix is a data file,
``traffic/<name>.json``, whose ``kind`` names a driver file,
``drivers/<kind>.py``, and whose other keys are that driver's parameters.
A new mix of a known kind is a new data file only; a new kind is a new
driver file, found by its name like a metric's reader.

A driver file defines ``Driver(sut, pool, traffic, seed)`` with:

* ``setup()``: warm up what the traffic uses, before the window;
* ``run(seconds)``: drive the window and return a ``Window`` holding every
  answer;
* ``trace()``: drive a short traced window of the same traffic afterwards
  and return ``(trace.Trace, Window)``.

``sut.held`` holds the rows a configuration holds back (``data.n_insert``)
for a driver to insert, in order.  A driver that changes the corpus hands
the check a ``MutationLog`` on its ``Window``, so that each answer is
judged against the rows that were live when its request was submitted.

Arrivals, mutations and the order of queries are drawn from the run's
seed.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from pilotbench import manifest, system


@dataclass
class Window:
    """What one window drove: the answers (pool query, ids, distances),
    their due and completion times on the benchmark's clock (seconds from
    the window's start), the batches the program ran, and the program's
    counters over the window.  ``open_loop``: requests arrived on their own
    schedule, so the answered rate is the offered one."""
    seconds: float
    n_due: int
    qidx: np.ndarray
    ids: np.ndarray
    dists: np.ndarray
    due_t: np.ndarray
    done_t: np.ndarray
    launches: Dict[str, int]
    open_loop: bool
    batches: int
    batch_stats: List[Dict[str, np.ndarray]] = field(default_factory=list)
    engine: Dict[str, float] = field(default_factory=dict)
    late_s: float = 0.0          # how far behind its schedule the sender ran
    # a window that changed the corpus: each answer's submit time, the
    # queries not from the pool (``qidx`` >= the pool's size indexes them),
    # the row each answer must hold (a read-back of an upsert; -1 for
    # none) and every mutation since the index was built
    submit_t: Optional[np.ndarray] = None
    queries: Optional[np.ndarray] = None
    reads_back: Optional[np.ndarray] = None
    mutations: Optional["MutationLog"] = None


@dataclass
class MutationLog:
    """Every mutation a driver made since the index was built over the
    first ``n_base`` rows, in submission order: its kind (``insert`` or
    ``delete``), the global ids it inserted or deleted (an inserted row's id
    is its row of the run's vectors) and the time, on the window's clock,
    at which the driver saw it done (-inf for those done before the
    window)."""
    n_base: int
    kinds: List[str]
    ids: List[np.ndarray]
    done_t: np.ndarray


def launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    """The program's kernel launches since ``before``, by kernel."""
    now = system.launch_counts()
    return {k: now[k] - before.get(k, 0) for k in now}


def load(root: Path, kind: str):
    """The ``Driver`` class of ``drivers/<kind>.py`` under ``root``."""
    path = manifest.driver_file(root, kind)
    if not path.is_file():
        raise ValueError(f"traffic kind {kind!r} has no driver file {path}")
    spec = importlib.util.spec_from_file_location(
        f"pilotbench_driver_{kind.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Driver


def make(root: Path, sut, pool: np.ndarray, traffic: dict, seed: int):
    return load(root, traffic["kind"])(sut, pool, traffic, seed)


def max_gap_s(done_t: np.ndarray, seconds: float) -> float:
    """The longest stretch of [0, seconds] with no completion (all of it
    where nothing completed)."""
    t = np.sort(done_t[done_t <= seconds])
    edges = np.concatenate([[0.0], t, [seconds]])
    return float(np.diff(edges).max())
