"""Reading a ``torch.profiler`` trace of a short traced window.

``traced(fn)`` runs ``fn`` under the profiler inside a span named
``WINDOW``; ``Trace`` keeps, from the events inside that span, the device
operations (kernels, copies, fills) and the host's spans and ops.  From
them: the device's busy seconds (the union of its operations' intervals),
device time by name, and the idle gaps, each named after the innermost
host event running at the gap's middle.
"""

from __future__ import annotations

import contextlib
import heapq
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "pilotbench.window"
SPAN_PREFIX = "pilotbench."     # the benchmark's own spans (``span``)
SHORT_GAP_US = 20.0          # idle gaps shorter than this are lumped


@dataclass
class Trace:
    window_s: float
    device: List[Tuple[str, float, float]]            # (name, start, dur) us
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    t0: float = 0.0                                   # window start, us

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, self.t0
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            s, e = max(s, end), s + d
            if e > s:
                busy += e - s
                end = e
        return busy / 1e6

    def device_us(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Summed device microseconds and count of the operations whose
        name ``match`` accepts."""
        sel = [d for n, _, d in self.device if match(n)]
        return sum(sel), len(sel)

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, _, d in self.device:
            out[n] += d
        return dict(out)

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds of the window by the innermost host event at each
        gap's middle (gaps under ``SHORT_GAP_US`` lumped together)."""
        t1 = self.t0 + 1e6 * self.window_s
        gaps, end = [], self.t0
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, s + d)
        if t1 > end:
            gaps.append((end, t1))
        out: Dict[str, float] = defaultdict(float)
        long_gaps = []
        for a, b in gaps:
            if b - a < SHORT_GAP_US:
                out[f"gaps under {SHORT_GAP_US:g} us"] += (b - a) / 1e6
            else:
                long_gaps.append(((a + b) / 2, b - a))
        long_gaps.sort()
        host = sorted(self.host, key=lambda e: e[1])
        active: List[Tuple[float, float, str]] = []   # (end, dur, name)
        i = 0
        for mid, width in long_gaps:
            while i < len(host) and host[i][1] <= mid:
                name, s, d = host[i]
                heapq.heappush(active, (s + d, d, name))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            inner = min(active, key=lambda e: e[1])[2] if active else "none"
            out[inner] += width / 1e6
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def idle_pct(tr: Optional[Trace], traced_window, window) -> Optional[float]:
    """The share of the untraced ``window`` in which the device ran no
    operation, in %: the device's busy seconds a batch in the traced
    window, times the batches a second of the untraced one.

    The traced window's own idle share is mostly the profiler's cost: it
    slows every graph launch on the host, and the device waits.  The
    operations' times on the device are what the profiler reads well, so
    only they are taken from it.  A batch's device time depends on its
    rows only through the bucket it is padded to, so where the traced
    window's batches are larger than the untraced ones this reads low."""
    if tr is None or traced_window is None or not tr.device \
            or not traced_window.batches or not window.batches \
            or not window.seconds:
        return None
    busy_per_batch = tr.busy_s / traced_window.batches
    return 100.0 * (1.0 - busy_per_batch * window.batches / window.seconds)


def span(name: str, on: bool):
    """A span named ``pilotbench.<name>`` in a trace, where ``on``; else
    nothing (the measured window runs without them)."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)


def traced(fn: Callable[[], None], device: torch.device,
           lead: Optional[Callable[[], None]] = None) -> Trace:
    """Run ``fn`` under the profiler; the window is the ``WINDOW`` span
    around it, closed after the device has finished.  ``lead`` runs first,
    traced but outside the window (a trace can lose its first device
    events)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    card = device.type == "cuda"
    if card:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        if lead is not None:
            lead()
            if card:
                torch.cuda.synchronize(device)
        t = time.perf_counter()
        with record_function(WINDOW):
            fn()
            if card:
                torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    return from_events(prof.events(), wall)


def from_events(events, wall_s: float) -> Trace:
    """A ``Trace`` from profiler events: those inside the ``WINDOW`` span
    (all of them, with ``wall_s`` as the window, where the span is
    missing)."""
    win: Optional[Tuple[float, float]] = None
    dev, host = [], []
    for e in events:
        s, d = e.time_range.start, e.time_range.elapsed_us()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a span's shadow on the device's timeline is no operation
            if not (e.name.startswith(SPAN_PREFIX)
                    or getattr(e, "is_user_annotation", False)):
                dev.append((e.name, s, d))
        elif e.name == WINDOW:
            win = (s, d)
        else:
            host.append((e.name, s, d))
    if win is None:
        t0 = min([s for _, s, _ in dev + host], default=0.0)
        return Trace(window_s=wall_s, device=dev, host=host, t0=t0)
    t0, t1 = win[0], win[0] + win[1]
    dev = [(n, s, d) for n, s, d in dev if s >= t0 and s + d <= t1]
    host = [(n, s, d) for n, s, d in host if s < t1 and s + d > t0]
    return Trace(window_s=win[1] / 1e6, device=dev, host=host, t0=t0)
