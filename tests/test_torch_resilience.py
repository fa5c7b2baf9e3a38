"""The port's resilient serving (the cases of ``tests/test_resilience.py``,
run against the port): the Request terminal
state machine, bounded admission with priority shedding, hard expiry, the
degraded rung, RestartPolicy-backed mutation retries and the admission
invariants, all on ``runtime.chaos``'s SimClock and FaultInjector; and the
sharded engine's shard failover and heal, held against the reference
engine's ids."""

import random

import numpy as np
import pytest
import torch

from repro_torch.core import (IndexConfig, PilotANNIndex, SearchParams,
                              SegmentedIndex, ShardedSegmentedIndex,
                              ShardParams, UpdateParams, degrade_params)
from repro_torch.runtime import (ChaosError, ElasticPolicy, FaultInjector,
                                 HeartbeatMonitor, RestartPolicy, SimClock,
                                 StragglerMitigator)
from repro_torch.serving import (BatchingQueue, Request, ServeParams,
                                 ThroughputEngine)

torch.set_num_threads(1)

CFG = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=512,
           build_method="exact")          # the built_index fixture's config
PARAMS = SearchParams(k=10, ef=32, ef_pilot=32)


@pytest.fixture(scope="module")
def port_index(built_index):
    return PilotANNIndex.from_arrays(
        IndexConfig(**CFG),
        {k: np.asarray(v) for k, v in built_index.arrays.items()},
        built_index.reducer.V, built_index.reducer.d_primary, device="cpu")


# ---------------------------------------------------------------------------
# Request, queue, policies
# ---------------------------------------------------------------------------

def test_request_exactly_one_terminal_state():
    r = Request(0, np.ones(4))
    assert r.state == "pending" and not r.terminal
    r.complete((1, 2))
    assert r.state == "completed" and r.done and r.terminal
    for bad in (lambda: r.reject("x"), r.expire, lambda: r.complete(3)):
        with pytest.raises(RuntimeError, match="second terminal"):
            bad()


def test_max_pending_rejects_and_sheds():
    clk = SimClock()
    q = BatchingQueue(8, max_wait_s=1.0, clock=clk, max_pending=2)
    a, b = q.submit(0), q.submit(1)
    c = q.submit(2)
    assert c.state == "rejected" and c.reject_reason == "queue_full"
    hi = q.submit(3, priority=5)                 # outranks the tail: sheds b
    assert b.state == "rejected" and b.reject_reason == "shed"
    assert [r.rid for r in q.pending] == [hi.rid, a.rid]
    assert q.counters == {"submitted": 4, "accepted": 3, "rejected": 2,
                          "expired": 0, "shed": 1}


def test_expired_work_frees_slots_before_shedding():
    clk = SimClock()
    q = BatchingQueue(8, max_wait_s=1.0, clock=clk, max_pending=2)
    a = q.submit(0, expiry=0.5)
    q.submit(1)
    clk.advance(1.0)
    c = q.submit(2)
    assert a.state == "expired" and c.state == "pending"
    assert q.counters["expired"] == 1 and q.counters["rejected"] == 0


def test_priority_order_preserved_under_requeue():
    q = BatchingQueue(8, max_wait_s=10.0)
    reqs = [q.submit(i, priority=p) for i, p in enumerate([0, 2, 1, 2, 0])]
    batch = q.drain(3)
    assert [r.priority for r in batch] == [2, 2, 1]
    q.requeue(batch)
    assert [r.rid for r in q.pending] == [1, 3, 2, 0, 4]
    assert len(reqs) == 5


def test_restart_policy_backoff_and_give_up():
    pol = RestartPolicy(max_restarts=3, base_backoff_s=1.0, max_backoff_s=3.0)
    assert [pol.next_backoff() for _ in range(4)] == [1.0, 2.0, 3.0, None]
    assert pol.replay_from(None) == 0 and pol.replay_from(7) == 8


def test_heartbeat_dead_then_alive():
    clk = SimClock()
    hb = HeartbeatMonitor(["shard:0", "shard:1"], timeout_s=1.0, clock=clk)
    clk.advance(2.0)
    hb.beat("shard:1")
    assert hb.dead_hosts() == ["shard:0"]
    hb.beat("shard:0")
    assert hb.dead_hosts() == []
    assert set(hb.alive_hosts()) == {"shard:0", "shard:1"}


def test_elastic_and_straggler_policies():
    assert ElasticPolicy(model_degree=4).propose_mesh(9) == ((2, 4),
                                                            ("data", "model"))
    assert ElasticPolicy(model_degree=4).propose_mesh(3) is None
    clk = SimClock()
    sm = StragglerMitigator(factor=2.0, min_history=2, clock=clk)
    for s in ("a", "b"):
        sm.issue(s)
        clk.advance(1.0)
        sm.complete(s)
    sm.issue("c")
    clk.advance(3.0)
    assert sm.backups_needed() == ["c"] and sm.backups_needed() == []


def test_fault_injector_windows():
    clk = SimClock()
    inj = FaultInjector(clk)
    with pytest.raises(ValueError, match="unknown fault"):
        inj.inject("meteor")
    inj.inject("mutation_failure", start=1.0, duration=1.0)
    assert not inj.mutation_should_fail()
    clk.advance(1.5)
    assert inj.mutation_should_fail() and inj.log
    assert inj.clear("mutation_failure") == 1 and not inj.faults
    assert issubclass(ChaosError, RuntimeError)


def test_degrade_params_low_cost_rung():
    lo = degrade_params(PARAMS, 0.5)
    assert lo.k == PARAMS.k and lo.ef == 16 and lo.ef_pilot == 16
    assert degrade_params(SearchParams(k=10, ef=12), 0.25).ef == 10
    with pytest.raises(ValueError):
        degrade_params(PARAMS, 0.0)


# ---------------------------------------------------------------------------
# the engine on a SimClock
# ---------------------------------------------------------------------------

def _engine(index, clock, injector, **sp_kw):
    sp = ServeParams(buckets=(8,), depth=1, donate=False, warmup=True,
                     max_wait_s=0.01, **sp_kw)
    return ThroughputEngine(index, PARAMS, sp, clock=clock,
                            fault_injector=injector)


def test_engine_expires_overdue_requests(port_index, small_dataset):
    clk = SimClock()
    eng = _engine(port_index, clk, None, slo_timeout_s=1.0)
    r = eng.submit(small_dataset.queries[0])
    assert r.expiry == pytest.approx(1.0)
    clk.advance(2.0)
    assert eng.pump()
    assert r.state == "expired" and r.result is None
    assert eng.stats["expired"] == 1 and eng.stats["completed"] == 0
    r2 = eng.submit(small_dataset.queries[1])
    eng.flush()
    assert r2.state == "completed" and eng.stats["completed"] == 1


def test_engine_admission_and_conservation(port_index, small_dataset):
    clk = SimClock()
    eng = _engine(port_index, clk, None, max_pending=2)
    qs = small_dataset.queries
    rs = [eng.submit(qs[i]) for i in range(3)]
    hi = eng.submit(qs[3], priority=9)
    assert rs[2].reject_reason == "queue_full"
    assert rs[1].reject_reason == "shed"
    eng.flush()
    states = [r.state for r in rs + [hi]]
    assert states.count("completed") == 2 and states.count("rejected") == 2
    s = eng.stats
    assert s["requests"] == 4
    assert s["completed"] + s["rejected"] + s["expired"] == 4
    assert hi.state == "completed"


def test_queue_stall_fault_ages_work_to_expiry(port_index, small_dataset):
    clk = SimClock()
    inj = FaultInjector(clk)
    eng = _engine(port_index, clk, inj, slo_timeout_s=0.5)
    inj.inject("queue_stall", duration=1.0)
    r = eng.submit(small_dataset.queries[0])
    clk.advance(0.1)
    assert eng.pump() is False and r.state == "pending"
    clk.advance(0.6)
    eng.pump()
    assert r.state == "expired"
    clk.advance(1.0)
    r2 = eng.submit(small_dataset.queries[1])
    clk.advance(0.02)
    eng.flush()
    assert r2.state == "completed" and inj.log


def test_slow_executable_triggers_degradation(port_index, small_dataset):
    clk = SimClock()
    inj = FaultInjector(clk)
    eng = _engine(port_index, clk, inj, p99_budget_s=0.05,
                  degrade_ef_scale=0.5, slo_window=8)
    qs = small_dataset.queries
    ids0, _, _ = eng.serve(qs[:8])
    assert eng.stats["degraded_batches"] == 0
    inj.inject("slow_executable", severity=0.2)
    eng.serve(qs[:8])
    eng.serve(qs[:8])
    assert eng.stats["degraded_batches"] >= 1
    recs = eng.stats["batch_records"]
    assert any(r["degraded"] for r in recs)
    ids2, d2, _ = eng.serve(qs[:8])
    assert ids2.shape == ids0.shape and np.isfinite(d2).all()


def test_degraded_rung_matches_degraded_params(port_index, small_dataset):
    """A batch served on the degraded rung is bit-equal to ``search`` at
    ``degrade_params``."""
    clk = SimClock()
    inj = FaultInjector(clk)
    eng = _engine(port_index, clk, inj, p99_budget_s=1e-9,
                  degrade_ef_scale=0.5, slo_window=8)
    qs = small_dataset.queries[:8]
    inj.inject("slow_executable", severity=1.0)
    eng.serve(qs)
    ids, dists, _ = eng.serve(qs)
    assert eng.stats["batch_records"][-1]["degraded"]
    rid, rd, _ = port_index.search(qs, degrade_params(PARAMS, 0.5))
    np.testing.assert_array_equal(ids, rid)
    np.testing.assert_array_equal(dists.view(np.uint32), rd.view(np.uint32))


def test_no_silent_drops_under_chaos(port_index, small_dataset):
    clk = SimClock()
    inj = FaultInjector(clk)
    eng = _engine(port_index, clk, inj, max_pending=4, slo_timeout_s=0.3)
    qs = small_dataset.queries
    inj.inject("queue_stall", start=0.1, duration=0.5)
    reqs = []
    for i in range(24):
        reqs.append(eng.submit(qs[i % len(qs)], priority=i % 3))
        clk.advance(0.05)
        eng.pump()
    clk.advance(1.0)
    eng.flush()
    states = [r.state for r in reqs]
    assert all(s in ("completed", "rejected", "expired") for s in states)
    s = eng.stats
    assert s["completed"] + s["rejected"] + s["expired"] == len(reqs)
    assert s["rejected"] > 0 and s["expired"] > 0
    assert s["completed"] == states.count("completed")


FAILOVER_CFG = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=128,
                    build_method="exact")


@pytest.fixture(scope="module")
def ref_engine_ids(small_dataset):
    """The reference engine's ids on the failover set-up: the healthy
    one-shard pod, and a single-device index with the rows of shard 1 of
    two deleted (the degraded oracle)."""
    from repro.core import IndexConfig as JIndexConfig
    from repro.core import SearchParams as JSearchParams
    from repro.core.distributed import ShardParams as JShardParams
    from repro.core.distributed import ShardedSegmentedIndex as JSharded
    from repro.core.segments import SegmentedIndex as JSegmentedIndex
    from repro.core.segments import UpdateParams as JUpdateParams
    from repro.serving import ServeParams as JServeParams
    from repro.serving import ThroughputEngine as JThroughputEngine

    x = small_dataset.vectors[:800]
    qs = small_dataset.queries[:8]
    cfg = JIndexConfig(**FAILOVER_CFG)
    sp = JServeParams(buckets=(8,), depth=1, donate=False, warmup=True)
    jp = JSearchParams(k=10, ef=32, ef_pilot=32)
    healthy = JThroughputEngine(JSharded(cfg, x, JUpdateParams(),
                                         shard_params=JShardParams(n_shards=1)),
                                jp, sp).serve(qs)[0]
    oracle = JSegmentedIndex(cfg, x, JUpdateParams())
    rp = -(-(len(x) + 1) // 2)
    oracle.delete(np.arange(rp, len(x)))
    degraded = JThroughputEngine(oracle, jp, sp).serve(qs)[0]
    return np.asarray(healthy), np.asarray(degraded), np.arange(rp, len(x))


@pytest.mark.parametrize("K", [1, 2])
def test_shard_failover_and_heal_bit_parity(small_dataset, ref_engine_ids,
                                            K):
    # the reference's test_shard_failover_and_heal_bit_parity: a stalled
    # shard (the only one at K 1, shard 1 at K 2) fails over past the
    # heartbeat timeout to the overlay, and heals back to the healthy bits
    want_healthy, want_degraded, dead_rows = ref_engine_ids
    index = ShardedSegmentedIndex(
        IndexConfig(**FAILOVER_CFG), small_dataset.vectors[:800],
        UpdateParams(), shard_params=ShardParams(n_shards=K),
        devices=["cpu"] * K)
    clk = SimClock()
    inj = FaultInjector(clk)
    sp = ServeParams(buckets=(8,), depth=1, donate=False, warmup=True,
                     max_wait_s=0.01, heartbeat_timeout_s=0.5)
    eng = ThroughputEngine(index, PARAMS, sp, clock=clk, fault_injector=inj)
    qs = small_dataset.queries[:8]
    ids0, d0, _ = eng.serve(qs)
    np.testing.assert_array_equal(ids0, want_healthy)
    stalled = K - 1
    inj.inject("shard_stall", shard=stalled)
    clk.advance(1.0)
    eng.pump()
    assert eng.stats["shard_failovers"] == 1
    assert index.dead_shards == {stalled}
    ids1, _, _ = eng.serve(qs)
    if K == 1:                     # total outage: nothing survives
        assert eng.stats["degraded_coverage"] == pytest.approx(1.0)
        assert (ids1 == -1).all()
    else:
        assert 0.0 < eng.stats["degraded_coverage"] < 1.0
        np.testing.assert_array_equal(index._dead_base_rows(),
                                      np.isin(np.arange(800), dead_rows))
        np.testing.assert_array_equal(ids1, want_degraded)
        assert not np.isin(ids1, dead_rows).any()
    inj.clear("shard_stall")
    eng.pump()
    assert eng.stats["shard_heals"] == 1
    assert eng.stats["degraded_coverage"] == 0.0
    ids2, d2, _ = eng.serve(qs)
    np.testing.assert_array_equal(ids0, ids2)
    np.testing.assert_array_equal(d0.view(np.uint32), d2.view(np.uint32))


# ---------------------------------------------------------------------------
# mutation retries (mutable index)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mut_vectors(small_dataset):
    return small_dataset.vectors[:608]


def _mut_engine(vectors, clk, inj, **kw):
    cfg = IndexConfig(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=128,
                      build_method="exact")
    idx = SegmentedIndex(cfg, vectors[:600], UpdateParams(), device="cpu")
    sp = ServeParams(buckets=(8,), depth=1, donate=False, warmup=False,
                     mutation_max_retries=2, **kw)
    return ThroughputEngine(idx, PARAMS, sp, clock=clk, fault_injector=inj)


def test_mutation_retry_backoff_and_give_up(mut_vectors):
    clk = SimClock()
    inj = FaultInjector(clk)
    eng = _mut_engine(mut_vectors, clk, inj, mutation_backoff_s=0.1)
    vecs = mut_vectors[600:608]
    inj.inject("mutation_failure", duration=0.15)
    t1 = eng.submit_upsert(vecs[:4])
    assert eng.pump()
    assert not t1.done and t1.attempts == 1
    assert eng.stats["mutation_retries"] == 1
    assert eng.pump() is False
    clk.advance(0.2)
    assert eng.pump()
    assert t1.done and not t1.failed and t1.gids is not None
    assert t1.attempts == 2
    inj.inject("mutation_failure")
    t2 = eng.submit_upsert(vecs[4:])
    for _ in range(5):
        clk.advance(1.0)
        eng.pump()
    assert t2.done and t2.failed and t2.gids is None
    assert "ChaosError" in t2.error
    assert eng.stats["mutation_failures"] == 1
    inj.clear()
    t3 = eng.submit_upsert(vecs[:2])
    eng.flush_mutations()
    assert t3.done and not t3.failed
    assert t1.attempts == 2 and t2.attempts == 3


def test_flush_mutations_ignores_backoff_but_not_give_up(mut_vectors):
    clk = SimClock()
    inj = FaultInjector(clk)
    eng = _mut_engine(mut_vectors, clk, inj, mutation_backoff_s=10.0)
    inj.inject("mutation_failure")
    t = eng.submit_upsert(mut_vectors[600:604])
    eng.flush_mutations()
    assert t.done and t.failed


# ---------------------------------------------------------------------------
# admission invariants (the reference's seeded sweep)
# ---------------------------------------------------------------------------

def _run_admission_ops(ops):
    clk = SimClock()
    q = BatchingQueue(4, max_wait_s=0.1, clock=clk, max_pending=5)
    all_reqs, inflight = [], []
    prev = dict(q.counters)
    for op in ops:
        if op[0] == "submit":
            _, prio, ttl = op
            all_reqs.append(q.submit(len(all_reqs), priority=prio,
                                     expiry=clk() + ttl))
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
        else:
            q.expire_due()
            now = clk()
            assert not any(r.expiry is not None and now >= r.expiry
                           for r in q.pending)
        for key, val in q.counters.items():
            assert val >= prev[key], key
        prev = dict(q.counters)
        prios = [r.priority for r in q.pending]
        assert prios == sorted(prios, reverse=True)
        assert len(q.pending) <= 5
        states = [r.state for r in all_reqs]
        assert states.count("rejected") == q.counters["rejected"]
        assert states.count("expired") == q.counters["expired"]
        n_live = states.count("pending")
        assert n_live == len(q.pending) + sum(
            1 for r in inflight if r.state == "pending")
        assert q.counters["submitted"] == len(all_reqs)
        assert q.counters["submitted"] == (q.counters["accepted"]
                                           + q.counters["rejected"]
                                           - q.counters["shed"])


def _random_ops(rng, n):
    ops = []
    for _ in range(n):
        kind = rng.choice(["submit", "submit", "submit", "advance",
                           "drain", "requeue", "sweep"])
        if kind == "submit":
            ops.append(("submit", rng.randrange(4), rng.uniform(0.05, 2.0)))
        elif kind == "advance":
            ops.append(("advance", rng.uniform(0.01, 1.0)))
        elif kind == "drain":
            ops.append(("drain", rng.randrange(1, 7)))
        else:
            ops.append((kind,))
    return ops


@pytest.mark.parametrize("seed", range(25))
def test_admission_invariants(seed):
    rng = random.Random(seed)
    _run_admission_ops(_random_ops(rng, rng.randrange(1, 51)))


@pytest.mark.parametrize("seed", range(25))
def test_requeue_keeps_priority_sorted(seed):
    rng = random.Random(1000 + seed)
    prios = [rng.randrange(5) for _ in range(rng.randrange(1, 21))]
    q = BatchingQueue(8, max_wait_s=10.0)
    for i, p in enumerate(prios):
        q.submit(i, priority=p)
    q.requeue(q.drain(min(rng.randrange(20) + 1, len(prios))))
    out = [r.priority for r in q.pending]
    assert out == sorted(out, reverse=True) and len(out) == len(prios)
