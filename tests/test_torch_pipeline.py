"""The port's stage pipeline (``core/pipeline.py``) against the reference's:
the donated stage-boundary contract and depth-D pipelining
(``tests/test_serving.py``'s cases, run against the port), with results
held against the port's ``search`` and the reference's ids."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import SearchParams as JSearchParams
from repro.core.pipeline import degrade_params as j_degrade_params
from repro_torch.core import (IndexConfig, PilotANNIndex, SearchParams,
                              ShardedSegmentedIndex, ShardParams,
                              degrade_params, pipelined_search, split_stages)
from repro_torch.core.pipeline import is_consumed, visited_buffer

torch.set_num_threads(1)

CFG = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=512,
           build_method="exact")          # the built_index fixture's config
PARAMS = SearchParams(k=10, ef=32, ef_pilot=32)
J_PARAMS = JSearchParams(k=10, ef=32, ef_pilot=32)


@pytest.fixture(scope="module")
def port_index(built_index):
    return PilotANNIndex.from_arrays(
        IndexConfig(**CFG),
        {k: np.asarray(v) for k, v in built_index.arrays.items()},
        built_index.reducer.V, built_index.reducer.d_primary, device="cpu")


def _same(got_ids, got_d, want_ids, want_d):
    np.testing.assert_array_equal(np.asarray(got_ids), np.asarray(want_ids))
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(want_d),
                               rtol=1e-6)


def test_visited_buffer_shapes(port_index):
    nk = port_index.n_pilot
    assert visited_buffer(PARAMS, 8, nk).shape == (8, PARAMS.bloom_bits)
    exact = dataclasses.replace(PARAMS, visited_mode="exact")
    b = visited_buffer(exact, 8, nk)
    assert b.shape == (8, nk + 1) and b.dtype == torch.bool and not b.any()


def test_split_stages_donation_invalidates_and_recycles(port_index,
                                                        small_dataset):
    rot = port_index.rotate_queries(small_dataset.queries[:16])
    pilot, cpu = split_stages(port_index.arrays, PARAMS, donate=True)
    pilot0, cpu0 = split_stages(port_index.arrays, PARAMS, donate=False)

    po = pilot(rot)
    vis_ptr = po[2].data_ptr()
    ids, dists = cpu(rot, *po)
    # consuming the boundary invalidates it (use-once contract)
    assert all(is_consumed(t) for t in po)
    with pytest.raises(RuntimeError, match="consumed"):
        cpu(rot, *po)
    # the visited filter's storage cycles back through the pool: the next
    # pilot of this size reuses the same buffer instead of allocating
    po2 = pilot(rot)
    assert po2[2].data_ptr() == vis_ptr and not is_consumed(po2[2])
    ids2, dists2 = cpu(rot, *po2)
    # bit-identical to the undonated path, on fresh AND recycled storage
    po0 = pilot0(rot)
    assert not any(is_consumed(t) for t in po0)
    ids0, dists0 = cpu0(rot, *po0)
    cpu0(rot, *po0)                         # undonated: reusable
    for got_i, got_d in ((ids, dists), (ids2, dists2)):
        assert torch.equal(got_i, ids0)
        assert torch.equal(got_d, dists0)
    for a, b in zip(po2, po0):
        assert torch.equal(a, b)


def test_donated_kernel_path_requires_aligned_batches(port_index,
                                                      small_dataset):
    for kw in ({"use_pallas_traversal": True},
               {"use_persistent_traversal": True}):
        params = dataclasses.replace(PARAMS, **kw)
        pilot, _ = split_stages(port_index.arrays, params, donate=True)
        with pytest.raises(ValueError, match="sublane-aligned"):
            pilot(port_index.rotate_queries(small_dataset.queries[:13]))
    # the torch stage-① path and the undonated kernel path take any batch
    for params, donate in ((PARAMS, True),
                           (dataclasses.replace(
                               PARAMS, use_persistent_traversal=True), False)):
        pilot, cpu = split_stages(port_index.arrays, params, donate=donate)
        rot = port_index.rotate_queries(small_dataset.queries[:13])
        ids, _ = cpu(rot, *pilot(rot))
        np.testing.assert_array_equal(
            ids.numpy(), port_index.search(small_dataset.queries[:13],
                                           params)[0])


@pytest.mark.parametrize("depth,donate,pipelined", [
    (1, False, True), (2, True, True), (3, True, True), (2, False, False)])
def test_pipelined_depth_matches_engine(built_index, port_index,
                                        small_dataset, depth, donate,
                                        pipelined):
    batches = [port_index.rotate_queries(
        small_dataset.queries[i * 16:(i + 1) * 16]) for i in range(4)]
    rec = []
    params = dataclasses.replace(PARAMS, use_persistent_traversal=True)
    results, dt = pipelined_search(port_index.arrays, params, batches,
                                   depth=depth, donate=donate,
                                   pipelined=pipelined, record_into=rec)
    assert dt > 0 and len(results) == 4
    for i, (ids, dists) in enumerate(results):
        q = small_dataset.queries[i * 16:(i + 1) * 16]
        eids, edists, _ = port_index.search(q, params)
        _same(ids, dists, eids, edists)
        rids, rdists, _ = built_index.search(q, J_PARAMS)
        np.testing.assert_array_equal(ids, np.asarray(rids))
        np.testing.assert_allclose(dists, np.asarray(rdists), rtol=1e-5,
                                   atol=1e-4)
    # per-stage timestamps: one record per batch, monotone within a batch
    assert sorted(r["batch"] for r in rec) == [0, 1, 2, 3]
    for r in rec:
        assert 0.0 <= r["t_pilot_dispatch"] <= r["t_cpu_start"] <= r["t_done"]


def test_pipelined_depth_validation(port_index, small_dataset):
    rot = [port_index.rotate_queries(small_dataset.queries[:8])]
    with pytest.raises(ValueError, match="depth"):
        pipelined_search(port_index.arrays, PARAMS, rot, depth=0)


@pytest.mark.parametrize("K,placement,donate", [
    (1, "hot-replicated", False), (2, "hot-replicated", True),
    (4, "hot-replicated", False), (2, "replicated", False),
    (4, "replicated", True)])
def test_sharded_split_stages_match_unsharded(small_dataset, K, placement,
                                               donate):
    # the sharded pair over a ShardedSegmentedIndex's per-shard layout
    # against the unsharded pair over its base arrays, with the same
    # bitmaps (some rows deleted): ids and distance bits
    sh = ShardedSegmentedIndex(
        IndexConfig(**dict(CFG, n_entry=128)), small_dataset.vectors[:600],
        shard_params=ShardParams(n_shards=K, placement=placement),
        devices=["cpu"] * K)
    sh.delete(np.arange(0, 600, 7))
    ptomb, tomb = sh.shard_tombs()
    rot = sh.rotate_queries(small_dataset.queries[:16])
    pilot, cpu = split_stages(sh._shard_arrays, PARAMS, donate=donate,
                              shard_ctx=sh._shard_ctx)
    pilot0, cpu0 = split_stages(sh.base.arrays, PARAMS)
    po = pilot(rot, ptomb)
    want_po = pilot0(rot, ptomb)
    for a, b in zip(po, want_po):
        assert torch.equal(a, b)
    ids, dists = cpu(rot, *po, ptomb, tomb)
    want = cpu0(rot, *want_po, ptomb, tomb)
    assert torch.equal(ids, want[0])
    assert torch.equal(dists.view(torch.int32), want[1].view(torch.int32))
    assert not np.isin(ids.numpy(), np.arange(0, 600, 7)).any()
    assert all(is_consumed(t) for t in po) == donate
    # the bitmaps are required, and 'replicated' splits the batch evenly
    with pytest.raises(TypeError, match="tombstone"):
        pilot(rot)
    if placement == "replicated":
        with pytest.raises(ValueError, match="divide by n_shards"):
            pilot(rot[:K + 1], ptomb)


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.1])
def test_degrade_params_like_reference(scale):
    got = degrade_params(PARAMS, scale)
    want = j_degrade_params(J_PARAMS, scale)
    assert (got.k, got.ef, got.ef_pilot, got.fes_L) == \
        (want.k, want.ef, want.ef_pilot, want.fes_L)
    assert dataclasses.replace(got, ef=PARAMS.ef, ef_pilot=PARAMS.ef_pilot,
                               fes_L=PARAMS.fes_L) == PARAMS
    with pytest.raises(ValueError, match="scale"):
        degrade_params(PARAMS, 0.0)
