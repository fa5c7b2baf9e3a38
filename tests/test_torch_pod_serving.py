"""Pod-scale sharded serving in the port: ``ShardedSegmentedIndex`` and the
sharded stage pair held bit for bit against the port's single-device
``SegmentedIndex`` (ids AND distance bits), on ``tests/test_pod_serving.py``'s
data and families — every shard on the CPU, in-process (the port's shards
are a list of ``torch.device``s; K shards may share one) — and the
single-device port held against the reference's ``SegmentedIndex``."""

import numpy as np
import pytest
import torch

from repro.core import IndexConfig as JIndexConfig
from repro.core import SearchParams as JSearchParams
from repro.core import SegmentedIndex as JSegmentedIndex
from repro.core import UpdateParams as JUpdateParams
from repro_torch.core import (IndexConfig, SearchParams, SegmentedIndex,
                              ShardedSegmentedIndex, ShardParams,
                              UpdateParams)
from repro_torch.serving import ServeParams, ThroughputEngine

torch.set_num_threads(1)

PARAMS = SearchParams(k=8, ef=32, ef_pilot=32)
CFG = dict(R=16, sample_ratio=0.35, n_entry=128, build_method="exact")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(700, 24)).astype(np.float32)
    # duplicated rows: exactly tied distances, so parity also checks the
    # (dist, gid) tie-break across shards
    x = np.concatenate([base, base[100:150]], axis=0)
    extra = rng.normal(size=(48, 24)).astype(np.float32)
    q = rng.normal(size=(21, 24)).astype(np.float32)
    q[:4] = x[110:114] + 1e-3        # steered at duplicated rows
    return x, extra, q


_REF = {}


def _single(data, pilot_dtype="float32"):
    """The single-device port's results on the pristine index (cached)."""
    if pilot_dtype not in _REF:
        idx = SegmentedIndex(IndexConfig(**CFG, pilot_dtype=pilot_dtype),
                             data[0], UpdateParams(), device="cpu")
        _REF[pilot_dtype] = idx.search(data[2], PARAMS)
    return _REF[pilot_dtype]


def _sharded(x, K, placement="hot-replicated", **cfg):
    return ShardedSegmentedIndex(
        IndexConfig(**CFG, **cfg), x, UpdateParams(),
        shard_params=ShardParams(n_shards=K, placement=placement),
        devices=["cpu"] * K)


def _bitexact(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(np.asarray(got[1]).view(np.uint32),
                                  np.asarray(want[1]).view(np.uint32))


@pytest.mark.parametrize("K,placement", [
    (1, "hot-replicated"), (2, "hot-replicated"), (4, "hot-replicated"),
    (8, "hot-replicated"), (2, "replicated"), (4, "replicated"),
    (8, "replicated")])
def test_base(data, K, placement):
    sh = _sharded(data[0], K, placement)
    got = sh.search(data[2], PARAMS)
    _bitexact(got, _single(data))
    assert set(got[2]) >= {"fes_dist", "final_dist", "delta_dist"}
    if placement == "hot-replicated":
        rp = sh._shard_ctx.rows_per
        assert rp * K >= sh.base.n + 1 > rp * (K - 1)
        assert [len(v) for v in sh._shard_arrays.values()] == \
            [K] * len(sh._shard_arrays)


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("pilot_dtype", ["int8", "int4", "pq"])
def test_quantized(data, pilot_dtype, K):
    # stage ① on the encoded tables, stage ② re-scores through the
    # dist_full_fn hook
    got = _sharded(data[0], K, pilot_dtype=pilot_dtype).search(data[2],
                                                               PARAMS)
    _bitexact(got, _single(data, pilot_dtype))


@pytest.fixture(scope="module")
def mutated_ref(data):
    x, extra, q = data
    ref = SegmentedIndex(IndexConfig(**CFG), x, UpdateParams(), device="cpu")
    ref.insert(extra[:24])
    ref.insert(extra[24:])
    dead = np.unique(ref.search(q, PARAMS)[0][:, 0])
    ref.delete(dead)
    out = ref.search(q, PARAMS)
    ref.compact()
    return dead, out, ref.search(q, PARAMS)


@pytest.mark.parametrize("K", [2, 4, 8])
def test_mutated(data, mutated_ref, K):
    x, extra, q = data
    dead, want, _ = mutated_ref
    sh = _sharded(x, K)
    sh.insert(extra[:24])
    sh.insert(extra[24:])
    assert [getattr(s, "shard") for s in sh.deltas] == [0, 1]
    sh.delete(dead)
    got = sh.search(q, PARAMS)
    _bitexact(got, want)
    assert not np.isin(got[0], dead).any()


def test_compacted(data, mutated_ref):
    x, extra, q = data
    dead, _, want = mutated_ref
    sh = _sharded(x, 4)
    sh.insert(extra[:24])
    sh.insert(extra[24:])
    sh.delete(dead)
    gen = sh.generation
    sh.compact()
    assert sh.generation == gen + 1 and not sh.deltas
    assert sh._shard_ctx.n == sh.base.n
    _bitexact(sh.search(q, PARAMS), want)


def _drive(engine, extra, q):
    t1 = engine.submit_upsert(extra[:24])
    ids1, d1, _ = engine.serve(q[:10])
    engine.flush_mutations()
    assert t1.done and t1.gids is not None
    t2 = engine.submit_upsert(extra[24:])
    t3 = engine.submit_delete(t1.gids[:5])
    engine.flush_mutations()
    assert t2.done and t3.done
    ids2, d2, _ = engine.serve(q[10:])
    return ids1, d1, ids2, d2, (t1.shard, t2.shard, t3.shard)


ENGINE_SP = ServeParams(buckets=(8, 16, 32), depth=2, donate=True,
                        warmup=True, mutations_per_pump=16)


@pytest.mark.parametrize("K", [2, 4])
def test_engine(data, K):
    # mutations interleaved with serving through the per-shard upsert
    # queues replay in the same global order
    x, extra, q = data
    want = _drive(ThroughputEngine(
        SegmentedIndex(IndexConfig(**CFG), x, UpdateParams(), device="cpu"),
        PARAMS, ENGINE_SP), extra, q)
    eng = ThroughputEngine(_sharded(x, K), PARAMS, ENGINE_SP)
    assert len(eng._mut_queues) == K
    got = _drive(eng, extra, q)
    _bitexact(got[:2], want[:2])
    _bitexact(got[2:4], want[2:4])
    # round-robin upserts; the delete rides the queue of its gids' owner
    # (the first insert's delta, on shard 0)
    assert got[4] == (0, 1, 0)
    rec = eng.stats["batch_records"][-1]
    assert "min_deadline" in rec
    assert eng.stats["upserts"] == 48 and eng.stats["deletes"] == 5


def test_degraded(data):
    # one dead shard: the overlay serves the bits of a single-device index
    # with that shard's base rows deleted (and its delta absent); heal
    # restores the healthy bits, with no new compiled program
    x, extra, q = data
    K = 4
    sh = _sharded(x, K)
    sh.insert(extra[:24], shard=2)           # delta pinned to the doomed shard
    healthy = sh.search(q, PARAMS)
    pilot, _ = sh.stage_pair(PARAMS, donate=False)
    programs = len(pilot.__self__._fns)
    rp = sh._shard_ctx.rows_per
    owner = np.minimum(np.arange(len(x)) // rp, K - 1)
    dead_gids = np.nonzero(owner == 2)[0]
    oracle = SegmentedIndex(IndexConfig(**CFG), x, UpdateParams(),
                            device="cpu")
    oracle.delete(dead_gids)
    frac = sh.set_dead_shards({2})
    assert 0.0 < frac < 1.0
    assert sh.dead_shards == {2}
    got = sh.search(q, PARAMS)
    _bitexact(got, oracle.search(q, PARAMS))
    assert not np.isin(got[0], dead_gids).any()
    assert not np.isin(got[0], np.arange(len(x), len(x) + 24)).any()
    sh.set_dead_shards(())
    assert sh.degraded_fraction() == 0.0
    _bitexact(sh.search(q, PARAMS), healthy)
    assert len(pilot.__self__._fns) == programs
    with pytest.raises(ValueError, match="out of range"):
        sh.set_dead_shards({K})


@pytest.mark.parametrize("K", [2, 4])
def test_persistent_stage_one(data, K):
    # the sharded pair runs stage ① through the kernel's contract (its
    # plain version here) as the unsharded pair does
    x, _, q = data
    p = SearchParams(k=8, ef=32, ef_pilot=32, use_persistent_traversal=True)
    want = SegmentedIndex(IndexConfig(**CFG), x, UpdateParams(),
                          device="cpu").search(q, p)
    _bitexact(_sharded(x, K).search(q, p), want)


@pytest.mark.parametrize("pilot_dtype", ["float32", "int8", "int4", "pq"])
def test_single_device_matches_reference(data, pilot_dtype):
    # rows 700..749 are copies of rows 100..149: their distances are equal
    # in exact arithmetic, and the port and the reference (another
    # summation order, 1-2 ulps apart) may order such a pair either way.
    # Ids are equal once each copy is read as its original, and a position
    # may differ only where the two ids are copies of one row
    x, _, q = data
    ref = JSegmentedIndex(JIndexConfig(**CFG, pilot_dtype=pilot_dtype), x,
                          JUpdateParams())
    rid, rd, _ = ref.search(q, JSearchParams(k=8, ef=32, ef_pilot=32))
    rid = np.asarray(rid)
    got = _single(data, pilot_dtype)
    orig = lambda ids: np.where((ids >= 700) & (ids < 750), ids - 600, ids)
    np.testing.assert_array_equal(orig(got[0]), orig(rid))
    swapped = got[0] != rid
    assert (orig(got[0])[swapped] >= 100).all() and \
        (orig(got[0])[swapped] < 150).all()
    assert swapped.sum() <= 4
    np.testing.assert_allclose(got[1], np.asarray(rd), rtol=1e-5, atol=1e-4)
