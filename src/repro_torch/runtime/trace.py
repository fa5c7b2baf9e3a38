"""The program's tracer: one registry of counters, and spans.

**Counters** are integers that the code adds to where the work happens
(``count``).  They are always on and cost one dict add each.  The registry
holds, under their names:

* each kernel wrapper's launches, by wrapper name (``fused_pilot_search``,
  ``fes_distances``, …; ``kernels.launch_counts`` lists them);
* ``search.host_tests`` and ``search.rounds``: the host tests of
  convergence a loop makes (one per ``traversal.CHUNK`` rounds) and the
  rounds it runs (``traversal.run_to_convergence``, ``core/compiled.py``);
* ``stage0.device_ns`` … ``stage3.device_ns``: device nanoseconds of each
  search stage inside the captured CUDA graphs, read from their timing
  events (below);
* ``engine.requests``, ``engine.queued_us``, ``engine.in_flight_us``,
  ``engine.drain_us``: the serving engine's completed requests and the
  three parts of their latency (``serving/server.py``);
* ``trace.readings_dropped``: graph timings never read because their graph
  ran again before the device had finished them (the engine's overlap):
  where it moved, the stage counters of that stretch hold less than the
  device ran, and a reader of them refuses the stretch.

``counts()`` (and so ``kernels.launch_counts()``) returns a copy of the
whole registry, after folding in every timing that has completed: a
snapshot taken after some calls holds exactly those calls' work.

**Spans** are profiler ranges named ``repro_torch.<what>`` (``span``),
opened only while tracing is on: while a torch profiler is active, or
after ``enable(True)``; ``enable(False)`` keeps them off even under a
profiler.  Off, a span is one shared null context behind one check.  On,
a span is PyTorch's C++ record-function guard
(``torch._C._profiler._RecordFunctionFast``), under 1 µs to open and
close on a host where ``torch.profiler.record_function`` takes 8: a batch
opens ~25 spans, and an engine that pumps often, more.  Its keyword values (``span(what, **kw)``)
land in the event's ``kwinputs`` where the profiler records shapes.
Being profiler events, spans share the device trace's clock.

**Graph timings.** A captured graph records timing events as nodes
(``torch.cuda.Event(enable_timing=True, external=True)``) at its start, at
each stage marker and at its end; every replay hands its ``Timing`` to
``timed``. It is read once ``query()`` says its last event has completed —
at a later registry read, or before the same graph runs again — and never
by a synchronisation of its own: an event query and one ``elapsed_time`` a
stretch, ~27 µs of host time a graph on an H100's host. A graph run again
before its earlier timing completed re-records the events, so that timing
is dropped and counted. The timings are read whether or not tracing is on,
because the profiler distorts them: its per-kernel tracing stretches the
device's gaps between the nodes of a graph (on an H100, stage ③'s ~4,600
kernels a batch read about twice their time under it), so the sound
reading is the one taken without it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

PREFIX = "repro_torch."
NULL = contextlib.nullcontext()

_counts: Dict[str, int] = {}
_forced: Optional[bool] = None
_pending: Dict["Timing", None] = {}     # ordered set of unread timings


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def add(delta: Dict[str, int]) -> None:
    """Add ``{name: n}`` to the counters."""
    for name, n in delta.items():
        _counts[name] = _counts.get(name, 0) + n


def declare(names: Sequence[str]) -> None:
    """Make ``names`` counters that read 0 until they move."""
    for name in names:
        _counts.setdefault(name, 0)


def counts(fold_timings: bool = True) -> Dict[str, int]:
    """A copy of the registry, with every completed timing folded in
    (``fold_timings=False``: as it stands)."""
    if fold_timings:
        fold()
    return dict(_counts)


def reset() -> None:
    """Zero every counter and forget the timings not read yet."""
    for name in _counts:
        _counts[name] = 0
    _pending.clear()


def enable(on: Optional[bool] = True) -> None:
    """Tracing on (``True``), off (``False``), or on exactly while a torch
    profiler is active (``None``, the default state)."""
    global _forced
    _forced = on


def tracing() -> bool:
    if _forced is not None:
        return _forced
    return torch.autograd._profiler_enabled()


def span(what: Optional[str], **values):
    """A span ``repro_torch.<what>`` (``values``: what the profiler keeps
    with it) while tracing is on, else (or for ``what=None``) the shared
    null context."""
    if what is None or not tracing():
        return NULL
    return torch._C._profiler._RecordFunctionFast(PREFIX + what, (), values)


class Timing:
    """The timing events of one captured graph: ``events[i]`` and
    ``events[i + 1]`` bound the device work of ``stages[i]`` (``None``: no
    stage, not counted).  The events live as long as the graph that
    records them."""

    def __init__(self, marks: List[Tuple[Optional[str], "torch.cuda.Event"]]):
        self.stages = [s for s, _ in marks[:-1]]
        # the graph holds nodes on these events, so they must live as long
        # as it does: a replay that records a freed event crashes the process
        self.events = [e for _, e in marks]

    def ready(self) -> bool:
        return self.events[-1].query()

    def read(self) -> None:
        ev = self.events
        for i, stage in enumerate(self.stages):
            if stage is not None:
                count(f"{stage}.device_ns",
                      round(1e6 * ev[i].elapsed_time(ev[i + 1])))


def settle(timing: Timing) -> None:
    """Before ``timing``'s graph runs again: read its last timing if the
    device has finished it, else drop it (the replay re-records it)."""
    if timing not in _pending:
        return
    del _pending[timing]
    if timing.ready():
        timing.read()
    else:
        count("trace.readings_dropped")


def timed(timing: Timing) -> None:
    """Queue the timing of a replay just launched, to be read once done."""
    _pending[timing] = None


def fold() -> None:
    """Read every queued timing that the device has finished."""
    for timing in [t for t in _pending if t.ready()]:
        del _pending[timing]
        timing.read()
