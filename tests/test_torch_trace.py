"""The port's tracer (``runtime/trace.py``): the counter registry, the
spans, the stage markers of the search programs, the graph timings' fold,
and the serving engine's per-request split on its one clock.

On the CPU there are no CUDA graphs, so no timing events: the fold of
graph timings is held here with stand-in events; the card's graphs record
real ones (``chip_smoke.py`` and the benchmark read them)."""

import contextlib
import gc
import itertools
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import kernels
from repro_torch.core import IndexConfig, PilotANNIndex, SearchParams
from repro_torch.core import compiled as C
from repro_torch.core import multistage as TM
from repro_torch.core import pipeline as TP
from repro_torch.core import traversal as TT
from repro_torch.runtime import trace
from repro_torch.serving import ServeParams, ThroughputEngine

torch.set_num_threads(1)

PARAMS = SearchParams(k=10, ef=32, ef_pilot=32)
STAGES = [f"stage{i}" for i in range(4)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(1500, 32)).astype(np.float32),
            rng.normal(size=(24, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def index(data):
    return PilotANNIndex(IndexConfig(R=16, sample_ratio=0.35, svd_ratio=0.5,
                                     n_entry=256, build_method="exact"),
                         data[0], device="cpu")


@pytest.fixture(autouse=True)
def follow_the_profiler():
    trace.enable(None)
    yield
    trace.enable(None)


def _spans(prof):
    """The program's spans of a profile: ``[(what, start, end)]`` in start
    order (``what`` without the ``repro_torch.`` prefix)."""
    out = [(e.name[len(trace.PREFIX):], e.time_range.start,
            e.time_range.end) for e in prof.events()
           if e.name.startswith(trace.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(np.asarray(a[1]).view(np.int32),
                                  np.asarray(b[1]).view(np.int32))
    if len(a) > 2:
        assert set(a[2]) == set(b[2])
        for k in a[2]:
            np.testing.assert_array_equal(a[2][k], b[2][k], err_msg=k)


# ---------------------------------------------------------------------------
# results do not depend on tracing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("baseline", [False, True])
def test_search_is_bit_equal_with_tracing_on_and_off(index, data, baseline):
    run = index.search_baseline if baseline else index.search
    trace.enable(False)
    off = run(data[1], PARAMS)
    trace.enable(True)
    on = run(data[1], PARAMS)
    _equal(off, on)


def test_stage_pair_is_bit_equal_with_tracing_on_and_off(index, data):
    q = index.rotate_queries(data[1][:16])
    got = []
    for on in (False, True):
        trace.enable(on)
        pilot, cpu = TP.split_stages(index.arrays, PARAMS, donate=True)
        po = pilot(q)
        boundary = [t.clone() for t in po]
        got.append((boundary, cpu(q, *po)))
    for a, b in zip(got[0][0], got[1][0]):
        assert torch.equal(a, b)
    _equal(got[0][1], got[1][1])


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_tracing_off_opens_no_span_under_the_profiler(index, data):
    trace.enable(False)
    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index.search(data[1], PARAMS)
    assert _spans(prof) == []
    after = kernels.launch_counts()
    for s in STAGES:
        assert after.get(f"{s}.device_ns", 0) == before.get(f"{s}.device_ns",
                                                            0)


def test_no_span_outside_the_profiler_unless_enabled():
    assert not trace.tracing()
    assert trace.span("search") is trace.NULL
    trace.enable(True)
    assert trace.tracing() and trace.span("search") is not trace.NULL
    assert trace.span(None) is trace.NULL


def test_multistage_spans_in_order_nested_in_search(index, data):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index.search(data[1], PARAMS)
    spans = _spans(prof)
    (_, s0, s1), = [s for s in spans if s[0] == "search"]
    stages = [s for s in spans if s[0] in STAGES]
    assert [s[0] for s in stages] == STAGES
    assert all(s0 <= a <= b <= s1 for _, a, b in stages)
    assert all(b1 <= a2 for (_, _, b1), (_, a2, _) in zip(stages,
                                                          stages[1:]))
    tests = [s for s in spans if s[0].endswith(".test")]
    assert {s[0] for s in tests} == {"stage1.test", "stage3.test"}
    by_name = {s[0]: s for s in stages}
    for name, a, b in tests:
        _, lo, hi = by_name[name[:-len(".test")]]
        assert lo <= a <= b <= hi
    (_, r0, _), = [s for s in spans if s[0] == "readback"]
    assert r0 >= s1


def test_stage_pair_spans_split_across_its_programs(index, data):
    q = index.rotate_queries(data[1][:16])
    pilot, cpu = TP.split_stages(index.arrays, PARAMS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cpu(q, *pilot(q))
    spans = _spans(prof)
    searches = [s for s in spans if s[0] == "search"]
    assert len(searches) == 2
    for (_, lo, hi), want in zip(searches, (STAGES[:2], STAGES[2:])):
        inside = [s[0] for s in spans if s[0] in STAGES and lo <= s[1] <= hi]
        assert inside == want


def _markers(program):
    """The stage markers a program yields, run eagerly."""
    names, item = [], next(program)
    try:
        while True:
            if isinstance(item, TT.Stage):
                names.append(item.name)
                item = program.send(None)
            else:
                item = program.send(TT.run_to_convergence(*item))
    except StopIteration:
        return names


@pytest.mark.parametrize("kw,want", [
    ({}, STAGES), ({"use_refine": False}, ["stage0", "stage1", "stage3"]),
    ({"use_pilot": False}, ["stage0", "stage3"])])
def test_programs_mark_their_stages(index, data, kw, want):
    q = index.rotate_queries(data[1][:8])
    params = SearchParams(**{**PARAMS.__dict__, **kw})
    assert _markers(TM.multistage_program(index.arrays, params, q)) == want
    assert _markers(TM.baseline_program(index.arrays, params, q)) == \
        ["stage3"]


def test_stage_pair_programs_mark_their_stages(index, data):
    q = index.rotate_queries(data[1][:8])
    assert _markers(TP.pilot_program(index.arrays, PARAMS, q)) == \
        STAGES[:2]
    boundary = TT.run_program(TP.pilot_program(index.arrays, PARAMS, q))
    assert _markers(TP.cpu_program(index.arrays, PARAMS, q, *boundary)) == \
        STAGES[2:]


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def test_host_tests_and_rounds_count_what_the_loop_did(index, data,
                                                       monkeypatch):
    tests, rounds = [0], [0]
    pending, expand = TT.pending, TT.expansion_round

    def counted_pending(state, n):
        tests[0] += 1
        return pending(state, n)

    def counted_round(*a, **kw):
        rounds[0] += 1
        return expand(*a, **kw)

    monkeypatch.setattr(TT, "pending", counted_pending)
    monkeypatch.setattr(TT, "expansion_round", counted_round)
    before = kernels.launch_counts()
    index.search(data[1], PARAMS)
    d = _delta(before, kernels.launch_counts())
    assert d["search.host_tests"] == tests[0] > 2
    # stage ②'s rounds are a fixed number, in no loop
    assert d["search.rounds"] == rounds[0] - PARAMS.refine_iters


def test_a_snapshot_holds_exactly_the_calls_since_the_last(index, data):
    q = data[1][:16]
    index.search(q, PARAMS)
    s0 = kernels.launch_counts()
    index.search(q, PARAMS)
    one = _delta(s0, kernels.launch_counts())
    assert one["search.host_tests"] >= 2 and one["search.rounds"] >= 1
    n, m = kernels.launch_counts(), 3
    for _ in range(m):
        index.search(q, PARAMS)
    assert _delta(n, kernels.launch_counts()) == {k: m * v
                                                  for k, v in one.items()}


def test_reset_zeroes_the_whole_registry(index, data):
    index.search(data[1][:8], PARAMS)
    kernels.reset_launch_counts()
    got = kernels.launch_counts()
    assert set(got) >= {"fused_pilot_search", "fes_distances",
                        "flash_attention_bf16", "search.host_tests"}
    assert not any(got.values())


class _Event:
    """A stand-in for a CUDA timing event: done once ``ready`` is set,
    at ``t`` ms."""

    def __init__(self, t, ready=True):
        self.t, self.done = t, ready

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.fixture
def clean_registry():
    trace.reset()
    yield
    trace.reset()


def test_graph_timings_fold_only_when_done(clean_registry):
    # a graph holding the end of stage 2 and the start of stage 3
    ev = [_Event(0.0), _Event(0.4), _Event(1.0004, ready=False)]
    t = trace.Timing(list(zip(["stage2", "stage3", None], ev)))
    trace.timed(t)
    assert trace.counts().get("stage2.device_ns", 0) == 0   # not done yet
    ev[-1].done = True
    got = trace.counts()
    assert got["stage2.device_ns"] == 400_000
    assert got["stage3.device_ns"] == 600_400
    trace.timed(t)
    trace.fold()
    assert trace.counts()["stage3.device_ns"] == 1_200_800
    # a replay launched before the last timing was done: that one is lost
    ev[-1].done = False
    trace.timed(t)
    trace.settle(t)
    got = trace.counts()
    assert got["trace.readings_dropped"] == 1
    assert got["stage3.device_ns"] == 1_200_800
    # a timing with no stage at its start counts nothing there
    u = trace.Timing([(None, _Event(0.0)), ("stage0", _Event(2.0)),
                      (None, _Event(2.5))])
    trace.timed(u)
    trace.settle(u)
    assert trace.counts()["stage0.device_ns"] == 500_000


def test_a_graph_keeps_its_timing_events_alive(monkeypatch):
    """Every event a captured graph records lives as long as the graph
    (its ``Timing`` holds them): a replay that records a freed event
    crashes the process.  Captured here with stand-ins for the graph and
    its events."""
    made = []

    class Event:
        def __init__(self, **kw):
            made.append(weakref.ref(self))

        def record(self):
            pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **kw: contextlib.nullcontext())
    prog = object.__new__(C.GraphedProgram)
    prog.pool = None

    def body(mark):
        for s in STAGES:
            mark(s)

    graph, _ = prog._graph(None, body, None)
    gc.collect()
    # the start, one event a stage, the end: all alive, and the timing's
    assert len(made) == len(STAGES) + 2
    assert [r() for r in made] == graph.timing.events
    assert graph.timing.stages == [None] + STAGES
    del graph
    gc.collect()
    assert all(r() is None for r in made)


# ---------------------------------------------------------------------------
# the engine: one clock, and each request's latency split exactly
# ---------------------------------------------------------------------------

def _ticking_clock(step=0.000731):
    """A clock that moves by ``step`` seconds at every read."""
    ticks = itertools.count()
    return lambda: next(ticks) * step


def _engine_delta(before):
    d = _delta(before, kernels.launch_counts())
    return {k: d.get(k, 0) for k in ("engine.requests", "engine.queued_us",
                                     "engine.in_flight_us",
                                     "engine.drain_us")}


def test_each_requests_latency_splits_exactly(index, data):
    clock = _ticking_clock()
    eng = ThroughputEngine(index, PARAMS,
                           ServeParams(buckets=(8,), depth=2,
                                       max_wait_s=0.0), clock=clock)
    assert eng.queue.clock is eng._clock
    for q in data[1][:5]:
        before = kernels.launch_counts()
        r = eng.submit(q)
        while not r.terminal:
            eng.pump()
        d = _engine_delta(before)
        assert d["engine.requests"] == 1
        parts = (d["engine.queued_us"], d["engine.in_flight_us"],
                 d["engine.drain_us"])
        assert all(p > 0 for p in parts)
        assert sum(parts) == round(1e6 * eng._completions[r.rid]) \
            - round(1e6 * r.enqueued_at)


def test_a_batch_of_requests_splits_exactly(index, data):
    eng = ThroughputEngine(index, PARAMS,
                           ServeParams(buckets=(8, 16), depth=2,
                                       max_wait_s=0.003),
                           clock=_ticking_clock(0.00113))
    before = kernels.launch_counts()
    reqs = [eng.submit(q) for q in data[1][:20]]
    eng.flush()
    d = _engine_delta(before)
    assert d["engine.requests"] == len(reqs) == eng.stats["completed"]
    want = sum(round(1e6 * eng._completions[r.rid])
               - round(1e6 * r.enqueued_at) for r in reqs)
    assert d["engine.queued_us"] + d["engine.in_flight_us"] \
        + d["engine.drain_us"] == want


def test_engine_spans_carry_the_batch_number(index, data, monkeypatch):
    eng = ThroughputEngine(index, PARAMS, ServeParams(buckets=(8,), depth=2,
                                                      max_wait_s=0.0))
    opened, span = [], trace.span

    def recording(what, **values):
        opened.append((what, values))
        return span(what, **values)

    monkeypatch.setattr(trace, "span", recording)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        for q in data[1][:3]:
            r = eng.submit(q)
            while not r.terminal:
                eng.pump()
    names = [s[0] for s in _spans(prof)]
    for want in ("engine.dispatch", "engine.drain", "engine.expire",
                 "readback"):
        assert want in names, want
    # no mutation was pending
    assert "engine.mutations" not in names
    for what in ("engine.dispatch", "engine.drain"):
        assert [v for w, v in opened if w == what] == [{"batch": i}
                                                       for i in range(3)]
        assert names.count(what) == 3
    drains = [e.kwinputs for e in prof.events()
              if e.name == trace.PREFIX + "engine.drain"]
    assert drains == [{"batch": i} for i in range(3)]
