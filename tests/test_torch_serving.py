"""The port's serving runtime (``serving/{batching,server,semantic_cache}``,
``launch/serve``) against the reference's: the batching queue on the same
op sequences, ``ThroughputEngine`` on a scripted ``SimClock`` timeline
(terminal states, counters, bucket histogram and ids equal to the
reference engine's; results bit-equal to the port's own ``search``), the
semantic-cache short-circuit, the mutable-index engine cases of
``tests/test_segments.py`` and the launcher at a tiny size."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import SearchParams as JSearchParams
from repro.runtime.chaos import FaultInjector as JFaultInjector
from repro.runtime.chaos import SimClock as JSimClock
from repro.serving import BatchingQueue as JBatchingQueue
from repro.serving import ServeParams as JServeParams
from repro.serving import ThroughputEngine as JThroughputEngine
from repro_torch.core import (IndexConfig, PilotANNIndex, SearchParams,
                              SegmentedIndex, UpdateParams, brute_force_topk,
                              recall_at_k)
from repro_torch.runtime import FaultInjector, SimClock
from repro_torch.serving import (BatchingQueue, SemanticCache, ServeParams,
                                 ThroughputEngine)
from repro_torch.serving.batching import row_of, run_query_batches

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=512,
           build_method="exact")          # the built_index fixture's config
PARAMS = SearchParams(k=10, ef=32, ef_pilot=32)
J_PARAMS = JSearchParams(k=10, ef=32, ef_pilot=32)
SEG_CFG = dict(CFG, n_entry=256)
SEG_PARAMS = SearchParams(k=10, ef=64, ef_pilot=64)


@pytest.fixture(scope="module")
def port_index(built_index):
    return PilotANNIndex.from_arrays(
        IndexConfig(**CFG),
        {k: np.asarray(v) for k, v in built_index.arrays.items()},
        built_index.reducer.V, built_index.reducer.d_primary, device="cpu")


@pytest.fixture(scope="module")
def seg_data():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2000, 32)).astype(np.float32)
    extra = rng.normal(size=(200, 32)).astype(np.float32)
    q = rng.normal(size=(32, 32)).astype(np.float32)
    return x, extra, q


# ---------------------------------------------------------------------------
# BatchingQueue against the reference's
# ---------------------------------------------------------------------------

def _queue_tape(rng, n):
    ops = []
    for _ in range(n):
        kind = rng.choice(["submit", "submit", "submit", "advance", "drain",
                           "requeue", "sweep", "ready"])
        if kind == "submit":
            ops.append(("submit", int(rng.integers(4)),
                        float(rng.uniform(0.05, 2.0))))
        elif kind == "advance":
            ops.append(("advance", float(rng.uniform(0.01, 1.0))))
        elif kind == "drain":
            ops.append(("drain", int(rng.integers(1, 7))))
        else:
            ops.append((kind,))
    return ops


def _run_queue(Queue, Clock, ops):
    """Drive a queue through an op tape; returns everything observable."""
    clk = Clock()
    q = Queue(4, max_wait_s=0.1, clock=clk, max_pending=5)
    reqs, inflight, seen = [], [], []
    for op in ops:
        if op[0] == "submit":
            reqs.append(q.submit(len(reqs), priority=op[1],
                                 expiry=clk() + op[2]))
        elif op[0] == "advance":
            clk.advance(op[1])
        elif op[0] == "drain":
            inflight.extend(q.drain(op[1]))
        elif op[0] == "requeue":
            for r in inflight[: len(inflight) // 2]:
                if not r.terminal:
                    r.complete("x")
            q.requeue(inflight)
            inflight = []
        elif op[0] == "ready":
            seen.append(q.ready())
        else:
            seen.append(len(q.expire_due()))
        seen.append(([r.rid for r in q.pending], dict(q.counters)))
    return ([(r.rid, r.state, r.reject_reason, r.priority, r.deadline,
              r.expiry) for r in reqs], seen)


@pytest.mark.parametrize("seed", range(8))
def test_batching_queue_matches_reference(seed):
    ops = _queue_tape(np.random.default_rng(100 + seed), 60)
    assert _run_queue(BatchingQueue, SimClock, ops) == \
        _run_queue(JBatchingQueue, JSimClock, ops)


def test_run_query_batches_pads_and_assigns():
    q = BatchingQueue(4, max_wait_s=0.0)
    r1 = q.submit(np.full(4, 1.0, np.float32))
    r2 = q.submit(np.full(4, 2.0, np.float32))
    seen = []
    n = run_query_batches(lambda x: seen.append(x.shape) or x.sum(axis=1),
                          q, 4)
    assert n == 1 and seen == [(4, 4)]
    assert float(r1.result) == pytest.approx(4.0)
    assert float(r2.result) == pytest.approx(8.0)
    got = row_of((np.arange(6).reshape(3, 2), np.arange(3)), 1)
    assert got[0].tolist() == [2, 3] and got[1] == 1


# ---------------------------------------------------------------------------
# ThroughputEngine against the reference's and against search
# ---------------------------------------------------------------------------

def test_engine_matches_search_bit_for_bit(port_index, built_index,
                                           small_dataset):
    """Closed loop: every batch of 32 (bucket 32), results bit-equal to the
    port's ``search`` on the same batches and ids equal to the reference
    engine's."""
    qs = small_dataset.queries[:96]
    sp = ServeParams(buckets=(8, 16, 32), depth=2, max_wait_s=0.0)
    eng = ThroughputEngine(port_index, PARAMS, sp)
    ids, dists, stats = eng.serve(qs)
    assert stats["bucket_hist"] == {32: 3}
    for i in range(0, 96, 32):
        sid, sd, _ = port_index.search(qs[i:i + 32], PARAMS)
        np.testing.assert_array_equal(ids[i:i + 32], sid)
        np.testing.assert_array_equal(dists[i:i + 32].view(np.uint32),
                                      sd.view(np.uint32))
    jeng = JThroughputEngine(built_index, J_PARAMS, JServeParams(
        buckets=(8, 16, 32), depth=2, max_wait_s=0.0))
    jids, jd, jstats = jeng.serve(qs)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(dists, jd, rtol=1e-5, atol=1e-4)
    assert stats["bucket_hist"] == jstats["bucket_hist"]
    assert sum(r["n_real"] for r in stats["batch_records"]) == 96
    assert (stats["latency_s"] > 0).all()


def _chaos_script(engine, clk, inj, qs):
    """The scripted overload of test_resilience's no-silent-drops case."""
    inj.inject("queue_stall", start=0.1, duration=0.5)
    reqs = []
    for i in range(24):
        reqs.append(engine.submit(qs[i % len(qs)], priority=i % 3))
        clk.advance(0.05)
        engine.pump()
    clk.advance(1.0)
    engine.flush()
    return reqs


def test_engine_matches_reference_on_simclock(port_index, built_index,
                                              small_dataset):
    """Overload + stall + expiry on a SimClock timeline: the same terminal
    state, reject reason and result ids per request, and the same counters
    and bucket histogram as the reference engine."""
    qs = small_dataset.queries[:24]
    kw = dict(buckets=(8,), depth=1, donate=False, warmup=True,
              max_wait_s=0.01, max_pending=4, slo_timeout_s=0.3)
    clk, jclk = SimClock(), JSimClock()
    eng = ThroughputEngine(port_index, PARAMS, ServeParams(**kw), clock=clk,
                           fault_injector=FaultInjector(clk))
    inj = eng._fault_injector
    jeng = JThroughputEngine(built_index, J_PARAMS, JServeParams(**kw),
                             clock=jclk, fault_injector=JFaultInjector(jclk))
    got = _chaos_script(eng, clk, inj, qs)
    want = _chaos_script(jeng, jclk, jeng._fault_injector, qs)
    assert [(r.state, r.reject_reason) for r in got] == \
        [(r.state, r.reject_reason) for r in want]
    for a, b in zip(got, want):
        if a.state == "completed":
            np.testing.assert_array_equal(a.result[0], np.asarray(b.result[0]))
    for key in ("requests", "batches", "completed", "rejected", "expired",
                "shed", "degraded_batches", "bucket_hist"):
        assert eng.stats[key] == jeng.stats[key], key
    s = eng.stats
    assert s["completed"] + s["rejected"] + s["expired"] == 24
    assert s["rejected"] > 0 and s["expired"] > 0


def test_engine_validation_and_depth(port_index, small_dataset):
    with pytest.raises(ValueError, match="depth"):
        ThroughputEngine(port_index, PARAMS, ServeParams(depth=0))
    with pytest.raises(ValueError, match="buckets"):
        ThroughputEngine(port_index, PARAMS, ServeParams(buckets=(32, 8)))
    serve = ServeParams(buckets=(8,), depth=2, max_wait_s=0.0, warmup=False)
    eng = ThroughputEngine(port_index, PARAMS, serve)
    for i in range(32):
        eng.submit(small_dataset.queries[i])
    seen = 0
    while eng.queue.pending or eng._inflight:
        assert len(eng._inflight) <= serve.depth
        if not eng.pump():
            break
        seen = max(seen, len(eng._inflight))
    assert seen == serve.depth and eng.stats["batches"] == 4
    ids, _, stats = eng.serve(np.zeros((0, port_index.d), np.float32))
    assert ids.shape == (0, PARAMS.k) and stats["requests"] == 0
    with pytest.raises(ValueError, match="SegmentedIndex"):
        eng.submit_upsert(np.zeros((1, port_index.d), np.float32))


def test_engine_semantic_cache_short_circuit(port_index, small_dataset):
    """Near-identical repeats hit the cache once its index builds (64
    inserts), and a hit returns the first answer of that query."""
    rng = np.random.default_rng(3)
    pool = small_dataset.queries[:4]
    warm = pool[rng.integers(0, 4, size=72)] + \
        rng.normal(scale=1e-5, size=(72, pool.shape[1])).astype(np.float32)
    serve = ServeParams(buckets=(8, 16, 32, 64, 128), depth=1,
                        max_wait_s=0.0, use_semantic_cache=True,
                        cache_threshold=0.05)
    eng = ThroughputEngine(port_index, PARAMS, serve)
    wids, _, warm_stats = eng.serve(warm.astype(np.float32))
    assert warm_stats["cache_lookups"] == 72
    assert eng.cache._index is not None
    assert eng.cache._index.device.type == "cpu"
    repeat_idx = rng.integers(0, 4, size=16)
    ids, dists, stats = eng.serve(pool[repeat_idx].astype(np.float32))
    assert stats["cache_hits"] > 0 and stats["batches"] < 16
    first = {}
    for w, row in zip(warm, wids):
        first.setdefault(int(np.argmin(((pool - w) ** 2).sum(1))), row)
    states = stats["request_states"]
    assert all(s == "completed" for s in states)
    for j, row in zip(repeat_idx, ids):
        np.testing.assert_array_equal(row, first[int(j)])


def test_semantic_cache_incremental_no_rebuild_stall():
    rng = np.random.default_rng(5)
    cache = SemanticCache(dim=16, threshold=0.05, rebuild_every=8,
                          device="cpu")
    keys = rng.normal(size=(80, 16)).astype(np.float32)
    for i, k in enumerate(keys):
        cache.insert(k, i)
    assert cache._index.deltas and cache._index.deltas[0].m == 16
    assert cache.lookup(keys[75] + 1e-4) == 75
    assert cache.maintenance_pending and cache.maintain()
    assert not cache._index.deltas
    assert cache.lookup(keys[75] + 1e-4) == 75
    assert cache.hits == 2 and cache.misses == 0 and cache.hit_rate == 1.0


# ---------------------------------------------------------------------------
# the mutable index under the engine (tests/test_segments.py's cases)
# ---------------------------------------------------------------------------

def _seg(x, **up):
    return SegmentedIndex(IndexConfig(**SEG_CFG), x, UpdateParams(**up),
                          device="cpu")


def test_engine_upsert_queue_interleaves(seg_data):
    x, extra, q = seg_data
    s = _seg(x)
    eng = ThroughputEngine(s, SEG_PARAMS, ServeParams(
        buckets=(8, 16, 32), depth=2, donate=True, warmup=True,
        max_wait_s=0.0, mutations_per_pump=32))
    t_up = eng.submit_upsert(extra[:64])
    t_del = eng.submit_delete(np.arange(8))
    for qq in q[:16]:
        eng.submit(qq)
    while eng.queue.pending or eng._inflight or eng._mutations_pending():
        if not eng.pump():
            break
    eng.flush()
    eng.flush_mutations()
    assert t_up.done and len(t_up.gids) == 64 and t_del.done
    assert eng.stats["upserts"] == 64 and eng.stats["deletes"] == 8
    ids, dd, _ = eng.serve(q)
    assert not np.isin(ids, np.arange(8)).any()
    full = np.concatenate([x, extra[:64]])
    live = np.setdiff1d(np.arange(len(full)), np.arange(8))
    gt = live[brute_force_topk(full[live], q, 10)]
    assert recall_at_k(ids, gt, 10) >= 0.85
    sid, sd, _ = s.search(q, SEG_PARAMS)
    np.testing.assert_array_equal(ids, sid)
    np.testing.assert_array_equal(dd.view(np.uint32), sd.view(np.uint32))


def _mutable_drive(eng, extra, q):
    """100 upserts (4 x 25) and 2 deletes interleaved with 16 queries,
    then 32 queries served: (the 16's ids, the served ids, upserted gids,
    counters)."""
    ups, reqs = [], []
    for i, qq in enumerate(q[:16]):
        reqs.append(eng.submit(qq))
        if i % 4 == 0:
            j = i // 4
            ups.append(eng.submit_upsert(extra[25 * j:25 * (j + 1)]))
        if i in (6, 13):
            eng.submit_delete([3 if i == 6 else 1000])
        eng.pump()
    while eng.queue.pending or eng._inflight or eng._mutations_pending():
        if not eng.pump():
            break
    eng.flush()
    eng.flush_mutations()
    served = eng.serve(q)[0]
    counters = {k: eng.stats[k] for k in ("upserts", "deletes",
                                          "mutation_drains", "stage_rebuilds",
                                          "batches", "completed")}
    return (np.stack([np.asarray(r.result[0]) for r in reqs]),
            np.asarray(served), np.concatenate([t.gids for t in ups]),
            counters)


@pytest.mark.parametrize("pilot_dtype", ["int8", "pq"])
def test_mutable_engine_quantized_matches_reference(seg_data, pilot_dtype):
    """The engine over a SegmentedIndex with an int8 or pq pilot (depth 2,
    donation) against the reference engine on the same script: ids,
    upserted gids and the six counters equal."""
    from repro.core import IndexConfig as JIndexConfig
    from repro.core.segments import SegmentedIndex as JSegmentedIndex
    from repro.core.segments import UpdateParams as JUpdateParams

    x, extra, q = seg_data
    cfg = dict(SEG_CFG, pilot_dtype=pilot_dtype)
    kw = dict(buckets=(8, 16, 32), depth=2, donate=True, warmup=True,
              max_wait_s=0.0, mutations_per_pump=32)
    got = _mutable_drive(ThroughputEngine(
        SegmentedIndex(IndexConfig(**cfg), x, UpdateParams(), device="cpu"),
        SEG_PARAMS, ServeParams(**kw), clock=SimClock()), extra, q)
    want = _mutable_drive(JThroughputEngine(
        JSegmentedIndex(JIndexConfig(**cfg), x, JUpdateParams()),
        JSearchParams(k=10, ef=64, ef_pilot=64), JServeParams(**kw),
        clock=JSimClock()), extra, q)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    assert got[3]["upserts"] == 100 and got[3]["deletes"] == 2


def test_engine_delete_without_recapture(seg_data):
    """A delete reaches the compiled stage pair through the in-place
    bitmaps: no stage rebuild, no new compiled program, the id gone."""
    x, _, q = seg_data
    s = _seg(x)
    eng = ThroughputEngine(s, SEG_PARAMS, ServeParams(
        buckets=(8, 16, 32), depth=1, donate=False, warmup=True,
        max_wait_s=0.0))
    ids0, _, _ = eng.serve(q[:8])
    before = s.base.compile_count()
    programs = eng.compile_count()
    assert programs == 6                       # pilot + cpu at 3 buckets
    dead = np.unique(ids0[:, 0])
    eng.submit_delete(dead)
    eng.flush_mutations()
    assert eng.stats["stage_rebuilds"] == 0
    ids1, _, _ = eng.serve(q[:8])
    assert not np.isin(ids1, dead).any()
    assert s.base.compile_count() == before
    assert eng.compile_count() == programs
    sid, _, _ = s.search(q[:8], SEG_PARAMS)
    np.testing.assert_array_equal(ids1, sid)


def test_engine_compact_rebuilds_stages(seg_data):
    x, extra, q = seg_data
    s = _seg(x, auto_compact_fraction=0.05)
    eng = ThroughputEngine(s, SEG_PARAMS, ServeParams(
        buckets=(8, 16), depth=1, donate=True, warmup=False, max_wait_s=0.0))
    eng.submit_upsert(extra[:128])               # > 5% of base -> compact
    eng.flush_mutations()
    assert s.generation == 1 and eng.stats["stage_rebuilds"] == 1
    ids, _, _ = eng.serve(q[:8])
    assert (ids[:, 0] >= 0).all()


def test_out_of_band_compact_detected_at_dispatch(seg_data):
    x, extra, q = seg_data
    s = _seg(x)
    eng = ThroughputEngine(s, SEG_PARAMS, ServeParams(
        buckets=(8, 16), depth=2, donate=True, warmup=True, max_wait_s=0.0))
    eng.serve(q[:8])
    s.insert(extra[:32])
    s.delete([3, 4])
    s.compact()
    ids_e, d_e, _ = eng.serve(q[:16])
    assert eng.stats["stage_rebuilds"] == 1
    ids_s, d_s, _ = s.search(q[:16], SEG_PARAMS)
    np.testing.assert_array_equal(ids_e, ids_s)
    np.testing.assert_array_equal(d_e.view(np.uint32), d_s.view(np.uint32))


# ---------------------------------------------------------------------------
# launcher and import hygiene
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--no-pipeline", "--donate"]],
                         ids=["pipelined", "sequential"])
def test_launch_serve_tiny(argv, capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--device", "cpu", "--n", "600", "--d", "16",
                     "--batch", "16", "--batches", "2", "--ef", "16"] + argv)
    assert rc == 0
    assert "QPS" in capsys.readouterr().out


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\s|\.|,|$)"
                        r"|from\s+repro(\s|\.))", re.M)


@pytest.mark.parametrize("rel", [
    "core/segments.py", "core/pipeline.py", "serving/batching.py",
    "serving/server.py", "serving/semantic_cache.py", "runtime/chaos.py",
    "runtime/fault_tolerance.py", "runtime/__init__.py", "launch/serve.py",
    "core/distributed.py", "../../chip_smoke.py"])
def test_new_modules_import_no_jax(rel):
    """The modules this slice adds (and chip_smoke.py) import neither JAX
    nor the JAX package."""
    text = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert not _FORBIDDEN.findall(text)


def test_semantic_cache_wider_than_its_first_build():
    """A cache of dim 96 builds its index on 64 rows, fewer than its dims:
    the port's SVD completes the rotation to 96 dims, so the next inserts
    land (the reference's economy SVD rotates to 64 dims and its 65th
    insert raises), and lookups hit."""
    from repro.serving import SemanticCache as JSemanticCache
    rng = np.random.default_rng(9)
    keys = rng.normal(size=(80, 96)).astype(np.float32)
    ref = JSemanticCache(dim=96)
    for i in range(64):
        ref.insert(keys[i], i)
    with pytest.raises(ValueError, match="broadcast"):
        ref.insert(keys[64], 64)
    cache = SemanticCache(dim=96, threshold=0.05, device="cpu")
    for i, k in enumerate(keys):
        cache.insert(k, i)
    assert cache._index.base.reducer.V.shape == (96, 96)
    assert cache._index.deltas[0].m == 16
    assert [cache.lookup(keys[i]) for i in (3, 70, 79)] == [3, 70, 79]


@pytest.mark.parametrize("module", [
    "repro_torch.kernels", "repro_torch.core", "repro_torch.core.segments",
    "repro_torch.serving", "repro_torch.runtime", "repro_torch.launch.serve"])
def test_each_package_imports_first(module):
    """Each package imports in a fresh interpreter as the first import (no
    import cycle through core/device_build and the kernels package)."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", f"import {module}"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
