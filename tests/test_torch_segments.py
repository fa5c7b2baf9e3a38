"""The port's mutable segmented index (``core/segments.py``) against the
reference's, on the same seeded data: the cases of ``tests/test_segments.py``
and of ``tests/test_graph_build_device.py``'s repair parity, run against the
port (the port's ``exact`` base build is array-for-array the reference's),
plus K1/K2's ``tombstone=`` operand in its plain versions against the
reference kernels in interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexConfig as JIndexConfig
from repro.core import SearchParams as JSearchParams
from repro.core import SegmentedIndex as JSegmentedIndex
from repro.core import UpdateParams as JUpdateParams
from repro.core import traversal as JT
from repro.core.segments import merge_topk as j_merge_topk
from repro_torch.core import (IndexConfig, PilotANNIndex, SearchParams,
                              SegmentedIndex, UpdateParams, brute_force_topk,
                              merge_topk, recall_at_k)
from repro_torch.core import multistage as M
from repro_torch.core import traversal as T
from repro_torch.kernels import fused_pilot_search, fused_traversal_hop

torch.set_num_threads(1)

CFG = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=256,
           build_method="exact")
PARAMS = SearchParams(k=10, ef=64, ef_pilot=64)
J_PARAMS = JSearchParams(k=10, ef=64, ef_pilot=64)
STATS = ("fes_dist", "pilot_dist", "pilot_hops", "pilot_expanded",
         "refine_dist", "final_dist", "final_hops", "final_expanded",
         "total_cpu_dist", "delta_dist")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2000, 32)).astype(np.float32)
    extra = rng.normal(size=(200, 32)).astype(np.float32)
    q = rng.normal(size=(32, 32)).astype(np.float32)
    return x, extra, q


def _pair(x, up=None, **cfg):
    """The port's and the reference's SegmentedIndex over the same data."""
    kw = dict(CFG, **cfg)
    up = up or {}
    return (SegmentedIndex(IndexConfig(**kw), x, UpdateParams(**up),
                           device="cpu"),
            JSegmentedIndex(JIndexConfig(**kw), x, JUpdateParams(**up)))


def _same_search(got, want, *, rtol=1e-5, atol=1e-4):
    """Ids and every stats key equal; distances at the stage-① bound."""
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=rtol,
                               atol=atol)
    for key in STATS:
        np.testing.assert_array_equal(np.asarray(got[2][key]),
                                      np.asarray(want[2][key]), err_msg=key)


def _same_delta(port, ref):
    assert len(port.deltas) == len(ref.deltas)
    for a, b in zip(port.deltas, ref.deltas):
        assert (a.m, a.cap, a.entry) == (b.m, b.cap, b.entry)
        np.testing.assert_array_equal(a.neighbors, b.neighbors)
        np.testing.assert_array_equal(a.gids, b.gids)
        np.testing.assert_array_equal(a.tomb, b.tomb)
        np.testing.assert_array_equal(a.rot, b.rot)
        assert set(a.arrays) == set(b.arrays)
        for k, v in a.arrays.items():
            want = np.asarray(b.arrays[k])
            got = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# zero tombstones: bit-exact with the plain index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params", [
    PARAMS,
    dataclasses.replace(PARAMS, use_pallas_traversal=True),
    dataclasses.replace(PARAMS, use_persistent_traversal=True),
], ids=["torch", "per_hop", "persistent"])
def test_zero_tombstone_bit_exact(data, params):
    """No inserts or deletes (all-false bitmaps installed): ids and
    distances bit-identical to a plain PilotANNIndex on every stage-①
    path, and the eager program without the bitmap keys agrees too."""
    x, _, q = data
    plain = PilotANNIndex(IndexConfig(**CFG), x, device="cpu")
    s = SegmentedIndex(IndexConfig(**CFG), x, device="cpu")
    assert not s.base.arrays["tombstone"].any()
    i1, d1, _ = plain.search(q, params)
    i2, d2, _ = s.search(q, params)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1.view(np.uint32), d2.view(np.uint32))
    bare = {k: v for k, v in s.base.arrays.items()
            if k not in ("tombstone", "pilot_tombstone")}
    i3, d3, _ = M.multistage_search(bare, params, s.rotate_queries(q))
    np.testing.assert_array_equal(i3.numpy(), i2)
    np.testing.assert_array_equal(d3.numpy().view(np.uint32),
                                  d2.view(np.uint32))


# ---------------------------------------------------------------------------
# inserts: the same adjacency as the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["device", "host"])
def test_insert_adjacency_matches_reference(data, method):
    """The same insert stream (a batch of 64, single rows, a batch of 40)
    gives exactly the reference's delta adjacency, gids, tombstones and
    tensors, under both repair methods."""
    x, extra, _ = data
    up = dict(repair_method=method, repair_knn=8, repair_ef=32)
    port, ref = _pair(x, up)
    for part in (extra[:64], extra[64:65], extra[65:66], extra[66:106]):
        g1, g2 = port.insert(part), ref.insert(part)
        np.testing.assert_array_equal(g1, g2)
        _same_delta(port, ref)
    port.delete([2003, 2070])
    ref.delete([2003, 2070])
    _same_delta(port, ref)


def test_single_insert_repair_host_device_bit_parity():
    """Single-row inserts: the device and host repairs give the same delta
    adjacency (tests/test_graph_build_device.py's case, on the port)."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(500, 24)).astype(np.float32)
    stream = rng.normal(size=(32, 24)).astype(np.float32)
    cfg = IndexConfig(**CFG)
    idx = {m: SegmentedIndex(cfg, base, UpdateParams(
        repair_method=m, repair_knn=8, repair_ef=32), device="cpu")
        for m in ("host", "device")}
    for v in stream:
        assert np.array_equal(idx["host"].insert(v), idx["device"].insert(v))
    sh, sd = idx["host"].deltas[-1], idx["device"].deltas[-1]
    assert sh.m == sd.m == len(stream)
    np.testing.assert_array_equal(sh.neighbors[:sh.m], sd.neighbors[:sd.m])


def test_repair_method_validation():
    rng = np.random.default_rng(2)
    base = rng.normal(size=(64, 8)).astype(np.float32)
    idx = SegmentedIndex(IndexConfig(**CFG), base,
                         UpdateParams(repair_method="bogus"), device="cpu")
    with pytest.raises(ValueError, match="repair_method"):
        idx.insert(base[:2])


def test_batched_device_repair_invariants():
    """Degree bound, no self loops, no duplicate edges, every edge to an
    appended row."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(400, 16)).astype(np.float32)
    idx = SegmentedIndex(IndexConfig(**CFG), base, UpdateParams(
        repair_method="device", repair_knn=8, repair_ef=32), device="cpu")
    for batch in np.split(rng.normal(size=(96, 16)).astype(np.float32), 4):
        idx.insert(batch)
    seg = idx.deltas[-1]
    nb = seg.neighbors[:seg.m]
    real = nb < seg.cap
    assert (real.sum(axis=1) <= seg.R).all()
    rows = np.broadcast_to(np.arange(seg.m)[:, None], nb.shape)
    assert not (real & (nb == rows)).any()
    assert (nb[real] < seg.m).all()
    for i in range(seg.m):
        kept = nb[i][real[i]]
        assert len(set(kept.tolist())) == len(kept)


# ---------------------------------------------------------------------------
# search after mutations: the reference's ids and stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["brute", "graph"])
def test_search_matches_reference(data, route):
    """After the same inserts and deletes: ids and every stats key
    (``delta_dist`` included) equal, distances at the stage-① bound, on
    the brute delta route and on the graph route (the delta past
    ``brute_threshold``, with its own FES)."""
    x, extra, q = data
    up = {"brute_threshold": 64} if route == "graph" else {}
    port, ref = _pair(x, up)
    port.insert(extra[:150])
    ref.insert(extra[:150])
    graph = port.deltas[0].live_count() > port.up.brute_threshold
    assert graph == (route == "graph")
    assert ("fes_centroids" in port.deltas[0].arrays) == graph
    _same_search(port.search(q, PARAMS), ref.search(q, J_PARAMS))
    dead = [0, 5, 2001, 2100]
    port.delete(dead)
    ref.delete(dead)
    got = port.search(q, PARAMS)
    _same_search(got, ref.search(q, J_PARAMS))
    assert not np.isin(got[0], dead).any()


def test_insert_recall_and_self_lookup(data):
    x, extra, q = data
    s = SegmentedIndex(IndexConfig(**CFG), x, device="cpu")
    s.insert(extra)
    full = np.concatenate([x, extra])
    gt = brute_force_topk(full, q, 10)
    once = PilotANNIndex(IndexConfig(**CFG), full, device="cpu")
    r_once = recall_at_k(once.search(q, PARAMS)[0], gt, 10)
    r_seg = recall_at_k(s.search(q, PARAMS)[0], gt, 10)
    assert r_seg >= r_once - 0.03, (r_seg, r_once)
    gids, dists, _ = s.search(extra[:16], PARAMS)
    assert (gids[:, 0] == 2000 + np.arange(16)).all()
    np.testing.assert_allclose(dists[:, 0], 0.0, atol=1e-3)
    rep = s.memory_report()
    assert [g["segment"] for g in rep["segments"]] == ["base", "delta0"]
    assert rep["total_pilot_bytes"] == \
        rep["pilot_bytes"] + rep["delta_pilot_bytes"] > rep["pilot_bytes"]


# ---------------------------------------------------------------------------
# deletes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params", [
    PARAMS, dataclasses.replace(PARAMS, use_pallas_traversal=True),
    dataclasses.replace(PARAMS, use_persistent_traversal=True)],
    ids=["torch", "per_hop", "persistent"])
def test_delete_never_surfaces(data, params):
    """Tombstoned ids (base and delta) never appear; delete is idempotent;
    liveness and counts follow."""
    x, extra, q = data
    s = SegmentedIndex(IndexConfig(**CFG), x, device="cpu")
    s.insert(extra)
    gt = brute_force_topk(np.concatenate([x, extra]), q, 10)
    dead = np.unique(np.concatenate([gt[:, 0], [2005, 2017, 42]]))
    assert s.delete(dead) == len(dead)
    assert s.delete(dead) == 0
    gids, _, _ = s.search(q, params)
    assert not np.isin(gids, dead).any()
    assert not s.is_live(dead).any()
    assert s.n_live == s.n_total - len(dead)


def test_delete_honored_by_fes_and_baseline(data):
    """The bitmaps reach FES entry selection, the coarse-layer path and the
    baseline; the port agrees with the reference on all three."""
    x, _, q = data
    port, ref = _pair(x)
    gids, _, _ = port.search(q, PARAMS)
    dead = np.unique(gids[:, 0])
    port.delete(dead)
    ref.delete(dead)
    nofes = dataclasses.replace(PARAMS, use_fes=False)
    for p, jp in ((PARAMS, J_PARAMS),
                  (nofes, dataclasses.replace(J_PARAMS, use_fes=False))):
        got = port.search(q, p)
        assert not np.isin(got[0], dead).any()
        _same_search(got, ref.search(q, jp))
    ib, _, _ = port.base.search_baseline(q, PARAMS)
    jb, _, _ = ref.base.search_baseline(q, J_PARAMS)
    np.testing.assert_array_equal(ib, np.asarray(jb))
    assert not np.isin(ib, dead).any()


def test_inplace_delete_keeps_compiled_searches(data):
    """A delete writes the bitmaps in place: the same tensors, the compiled
    searches kept (``compile_count`` unchanged), the deleted ids gone."""
    x, _, q = data
    s = SegmentedIndex(IndexConfig(**CFG), x, device="cpu")
    s.base.warmup(PARAMS, buckets=(32,))
    before = s.base.compile_count()
    tomb = s.base.arrays["tombstone"]
    ptomb = s.base.arrays["pilot_tombstone"]
    gids, _, _ = s.search(q, PARAMS)
    dead = np.unique(gids[:, :2])
    s.delete(dead)
    assert s.base.arrays["tombstone"] is tomb
    assert s.base.arrays["pilot_tombstone"] is ptomb
    assert int(tomb.sum()) == len(dead)
    g2, _, _ = s.search(q, PARAMS)
    assert not np.isin(g2, dead).any()
    assert s.base.compile_count() == before


def test_delta_refresh_in_place_keeps_graph_search(data):
    """Past ``brute_threshold`` the delta's search is compiled once per
    bucket and survives later refreshes of the same shapes (deletes write
    its tensors in place); a capacity doubling replaces them."""
    x, extra, q = data
    s = SegmentedIndex(IndexConfig(**CFG), x,
                       UpdateParams(brute_threshold=40, delta_capacity=128),
                       device="cpu")
    s.insert(extra[:100])
    seg = s.deltas[0]
    s.search(q, PARAMS)
    fn = seg.compiled[(32, dataclasses.astuple(PARAMS), 10)]
    arrays = seg.arrays
    s.delete([2001, 2002])
    assert seg.arrays is arrays and seg.compiled[
        (32, dataclasses.astuple(PARAMS), 10)] is fn
    g, _, _ = s.search(q, PARAMS)
    assert not np.isin(g, [2001, 2002]).any()
    s.insert(extra[100:150])                   # 150 > 128: capacity doubles
    assert seg.cap == 256 and seg.arrays is not arrays and not seg.compiled


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

def test_compact_matches_reference(data):
    """compact() keeps gids, drops tombstones and builds the reference's
    base arrays; searches after it agree."""
    x, extra, q = data
    port, ref = _pair(x)
    for s in (port, ref):
        s.insert(extra)
        s.delete(np.asarray([0, 1, 2000, 2001]))
        s.compact()
    assert port.generation == ref.generation == 1
    assert not port.deltas and port.n_total == port.n_live == 2200 - 4
    assert not port.base.arrays["tombstone"].any()
    np.testing.assert_array_equal(port._base_gids, ref._base_gids)
    for k, v in ref.base.arrays.items():
        np.testing.assert_array_equal(port.base.arrays[k].numpy(),
                                      np.asarray(v), err_msg=k)
    _same_search(port.search(q, PARAMS), ref.search(q, J_PARAMS))


def test_compact_replans_budget():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(1200, 32)).astype(np.float32)
    cfg = IndexConfig(**dict(CFG, sample_ratio=0.3, n_entry=128))
    probe = PilotANNIndex(cfg, x, device="cpu")
    budget = int(probe.memory_report()["pilot_bytes"] * 1.15)
    s = SegmentedIndex(dataclasses.replace(cfg, pilot_budget_bytes=budget),
                       x, device="cpu")
    s.insert(rng.normal(size=(600, 32)).astype(np.float32))
    s.compact()
    assert s.base.memory_report()["pilot_bytes"] <= budget
    assert s.base.cfg.pilot_budget_bytes == budget


def test_auto_compact_triggers():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(600, 24)).astype(np.float32)
    s = SegmentedIndex(IndexConfig(**dict(CFG, sample_ratio=0.3,
                                          n_entry=128)), x,
                       UpdateParams(auto_compact_fraction=0.1,
                                    delta_capacity=32), device="cpu")
    s.insert(rng.normal(size=(100, 24)).astype(np.float32))
    assert s.generation == 1 and not s.deltas and s.base.n == 700


@pytest.mark.parametrize("pilot_dtype", ["bfloat16", "int8", "int4", "pq"])
def test_quantized_pilot_lifecycle_matches_reference(data, pilot_dtype):
    """The reference's ``test_deep_pilot_mutable_lifecycle_identical_ids``
    set-up with a quantized pilot: insert 200, delete 6, compact, search
    at ef 96 after each step, with stage ① in torch ops, per-hop and
    persistent (the kernels' plain versions here): ids and every stats key
    equal to the reference's (whose fused paths equal its jnp path), and
    every delta array equal."""
    x, extra, q = data
    port, ref = _pair(x, pilot_dtype=pilot_dtype)
    want_p = dataclasses.replace(J_PARAMS, ef=96, ef_pilot=96)
    ways = [dataclasses.replace(PARAMS, ef=96, ef_pilot=96, **kw) for kw in (
        {}, {"use_pallas_traversal": True},
        {"use_persistent_traversal": True})]
    dead = np.asarray([0, 1, 5, 2000, 2001, 2100])
    steps = (lambda s: s.insert(extra), lambda s: s.delete(dead),
             lambda s: s.compact())
    for i, step in enumerate(steps):
        step(port)
        step(ref)
        _same_delta(port, ref)
        want = ref.search(q, want_p)
        for p in ways:
            got = port.search(q, p)
            _same_search(got, want)
            if i:
                assert not np.isin(got[0], dead).any()
    assert port.generation == 1 and not port.deltas


def test_merge_topk_matches_reference():
    rng = np.random.default_rng(5)
    g = rng.integers(-1, 50, size=(6, 12)).astype(np.int64)
    d = rng.integers(0, 4, size=(6, 12)).astype(np.float32)   # many ties
    for k in (5, 12, 15):
        a, b = merge_topk(g, d, k), j_merge_topk(g, d, k)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_no_device_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default here")
    x = np.zeros((64, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegmentedIndex(IndexConfig(**CFG), x)


# ---------------------------------------------------------------------------
# K1/K2's tombstone operand: the plain versions against the reference
# kernels in interpret mode (tests/test_segments.py's two cases)
# ---------------------------------------------------------------------------

def _kernel_case(seed, dead_count=0):
    rng = np.random.default_rng(seed)
    n, R, d, Bq, ef = 400, 8, 16, 8, 24
    nbr = np.concatenate([rng.integers(0, n, (n, R)),
                          np.full((1, R), n)]).astype(np.int32)
    vec = np.concatenate([rng.normal(size=(n, d)),
                          np.zeros((1, d))]).astype(np.float32)
    q = rng.normal(size=(Bq, d)).astype(np.float32)
    entries = rng.integers(0, n, (Bq, 4)).astype(np.int32)
    dead = np.zeros(n + 1, bool)
    if dead_count:
        dead[rng.choice(n, dead_count, replace=False)] = True
    return n, nbr, vec, q, entries, dead


@pytest.mark.parametrize("dead_count", [0, 50], ids=["all_false", "dead_50"])
@pytest.mark.parametrize("persistent", [False, True], ids=["K2", "K1"])
def test_kernel_tombstone_operand_matches_reference(dead_count, persistent):
    """The plain K1/K2 with ``tombstone=`` against the reference kernels in
    interpret mode: ids, flags, visited bits and counters equal, distances
    within float noise; an all-false bitmap is bit-equal to no bitmap, and
    no deleted id reaches the beam."""
    from repro.kernels.traversal_kernel import (fused_pilot_search as jk1,
                                                fused_traversal_hop as jk2)
    n, nbr, vec, q, entries, dead = _kernel_case(3 + dead_count, dead_count)
    jst = JT.init_state(JT.TraversalSpec(ef=24), jnp.asarray(q),
                        jnp.asarray(entries), jnp.asarray(vec[:-1]), n)
    st = T.init_state(T.TraversalSpec(ef=24), torch.from_numpy(q),
                      torch.from_numpy(entries), torch.from_numpy(vec), n)
    np.testing.assert_array_equal(st.cand_id.numpy(), np.asarray(jst.cand_id))
    args = (torch.from_numpy(q), torch.from_numpy(nbr), torch.from_numpy(vec),
            st.cand_id, st.cand_d, st.checked, st.visited, n)
    jargs = (jnp.asarray(q), jnp.asarray(nbr), jnp.asarray(vec), jst.cand_id,
             jst.cand_d, jst.checked, jst.visited, n)
    kw = dict(rounds=6) if persistent else {}
    fn, jfn = (fused_pilot_search, jk1) if persistent else \
        (fused_traversal_hop, jk2)
    got = fn(*args, tombstone=torch.from_numpy(dead), **kw)
    want = jfn(*jargs, interpret=True, tombstone=jnp.asarray(dead), **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 1:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-4)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    beam = got[0].numpy()
    assert not dead[beam[beam < n]].any()
    if not dead_count:
        bare = fn(*args, **kw)
        for a, b in zip(got, bare):
            assert torch.equal(a, b)
