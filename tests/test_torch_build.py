"""PyTorch port vs the JAX reference: the device graph build
(``core/device_build``), its candidate merge (``kernels/ref.
candidate_merge_ref``, the plain version of the CUDA merge) and the
insert-repair primitives of ``core/graph_build``.

Both sides get the same numpy inputs.  The JAX side runs as its own tests
run it on the CPU (jnp paths, the Pallas merge in interpret mode); the port
runs its plain PyTorch path on ``device="cpu"``.  The CUDA kernel itself is
held against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import IndexConfig as JIndexConfig
from repro.core import PilotANNIndex as JPilotANNIndex
from repro.core import SearchParams as JSearchParams
from repro.core import device_build as JDB
from repro.core import graph_build as JGB
from repro.kernels.build_kernel import fused_candidate_merge as j_merge_kernel
from repro.kernels.ref import candidate_merge_ref as j_merge_ref
from repro_torch.core import IndexConfig, PilotANNIndex, SearchParams
from repro_torch.core import device_build as TDB
from repro_torch.core import graph_build as TGB
from repro_torch.core.engine import brute_force_topk, recall_at_k
from repro_torch.data import synthetic_vectors
from repro_torch.kernels import build_kernel, launch_counts

# Small tensors and many ops: one intra-op thread is faster, and leaves the
# cores to the other pytest workers of a parallel run.
torch.set_num_threads(1)

BIG = np.float32(3.0e38)


def _merge_case(seed, B=12, K=16, P=24, n=1000):
    """Candidate/proposal lists with sentinels and cross-list duplicates
    (the generator of tests/test_graph_build_device.py)."""
    rng = np.random.default_rng(seed)
    cid = rng.integers(0, n, (B, K)).astype(np.int32)
    pid = rng.integers(0, n, (B, P)).astype(np.int32)
    pid[:, :4] = cid[:, :4]
    cid[:, K - 2:] = n
    pid[rng.random((B, P)) < 0.1] = n
    cd = rng.uniform(0, 4, (B, K)).astype(np.float32)
    pd_ = rng.uniform(0, 4, (B, P)).astype(np.float32)
    cd[cid >= n] = np.float32(np.inf)
    pd_[:, :2] = cd[:, :2] + 0.5
    pd_[:, 2:4] = np.maximum(cd[:, 2:4] - 0.25, 0)
    return cid, cd, pid, pd_, n


def _tie_case(seed, B=9, K=8, P=20, n=50):
    """Few distinct ids and distances: many id repeats, exact distance ties
    across ids, -0.0 beside +0.0, BIG rows and ids past n."""
    rng = np.random.default_rng(seed)
    cid = rng.integers(0, n + 3, (B, K)).astype(np.int32)
    pid = rng.integers(0, n + 3, (B, P)).astype(np.int32)
    levels = np.array([0.0, -0.0, 0.5, 1.0, BIG], np.float32)
    cd = levels[rng.integers(0, len(levels), (B, K))]
    pd_ = levels[rng.integers(0, len(levels), (B, P))]
    cid[0], cd[0] = n, BIG                      # an empty incumbent row
    return cid, cd, pid, pd_, n


def _port_merge(cid, cd, pid, pd_, n):
    out = build_kernel.fused_candidate_merge(
        *(torch.from_numpy(a) for a in (cid, cd, pid, pd_)), n)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("case", [_merge_case, _tie_case])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_merge_matches_reference(case, seed):
    """(a) Ids and live distances exactly equal to the reference's jnp
    oracle and its Pallas kernel in interpret mode (the tie case against
    the oracle alone: the Pallas kernel's fp32 id keys cannot hold n + 3
    sentinels apart from n)."""
    cid, cd, pid, pd_, n = case(seed)
    got_i, got_d = _port_merge(cid, cd, pid, pd_, n)
    args = [jnp.asarray(a) for a in (cid, cd, pid, pd_)]
    wants = [j_merge_ref(*args, n)]
    if case is _merge_case:
        wants.append(j_merge_kernel(*args, n, interpret=True))
    for want_i, want_d in wants:
        want_i, want_d = np.asarray(want_i), np.asarray(want_d)
        np.testing.assert_array_equal(got_i, want_i)
        live = want_i < n
        np.testing.assert_array_equal(got_d[live].view(np.int32),
                                      want_d[live].view(np.int32))
        assert (got_d[~live] == BIG).all()


def test_candidate_merge_wrapper_counts_only_kernel_launches():
    cid, cd, pid, pd_, n = _merge_case(0)
    before = launch_counts()["fused_candidate_merge"]
    _port_merge(cid, cd, pid, pd_, n)
    assert launch_counts()["fused_candidate_merge"] == before


def _near_tie_only(got_i, want_i, want_d, rel=1e-5):
    """Ids may differ only where the reference's distance has an adjacent
    neighbour within ``rel``."""
    diff = got_i != want_i
    tol = rel * np.maximum(np.abs(want_d), 1e-30)
    near = np.zeros_like(diff)
    gap = np.abs(want_d[:, 1:] - want_d[:, :-1])
    near[:, 1:] |= gap <= tol[:, 1:]
    near[:, :-1] |= gap <= tol[:, :-1]
    assert (near | ~diff).all(), np.argwhere(diff & ~near)[:5]


@pytest.mark.parametrize("seed", [0, 1])
def test_nn_descent_round_matches_reference(seed):
    """(c) One sample-and-merge round from identical (ids, dd)."""
    rng = np.random.default_rng(seed)
    n, d, K, S = 257, 12, 8, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids, dd = JDB.nn_descent(x, K, rounds=1, seed=seed, S=S)
    dd = np.where(ids >= n, BIG, dd).astype(np.float32)
    x_pad = np.concatenate([x, np.zeros((1, d), np.float32)])
    jx = jnp.asarray(x_pad)
    want_i, want_d = JDB._nn_descent_round(
        jx, jnp.sum(jx * jx, axis=-1), jnp.asarray(ids), jnp.asarray(dd),
        n=n, S=S, block=64, use_pallas=False, interpret=True)
    tx = torch.from_numpy(x_pad)
    got_i, got_d = TDB._nn_descent_round(
        tx, (tx * tx).sum(-1), torch.from_numpy(ids), torch.from_numpy(dd),
        n=n, S=S, block=64, local=False)
    want_i, want_d = np.asarray(want_i), np.asarray(want_d)
    _near_tie_only(got_i.numpy(), want_i, want_d)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5, atol=1e-6)


def test_reverse_lists_match_reference():
    rng = np.random.default_rng(3)
    n, S = 40, 5
    nbr = rng.integers(0, n + 1, (n, S)).astype(np.int32)
    want = np.asarray(JDB._reverse_lists(jnp.asarray(nbr), n, S))
    got = TDB._reverse_lists(torch.from_numpy(nbr), n, S).numpy()
    np.testing.assert_array_equal(got, want)


def _knn_recall(ids, gt):
    return np.mean([len(set(a) & set(b)) / gt.shape[1]
                    for a, b in zip(ids, gt)])


def test_nn_descent_recall_matches_reference():
    """(d) 300 x 12, K 8, S 4, 3 rounds: the 8-NN lists' recall against
    exact neighbours within 0.01 of the reference's with the reference's
    proposals, and no lower with the local join (``nn_descent``)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(300, 12)).astype(np.float32)
    gt, _ = TGB.brute_knn(x, 8)
    fwd_i, _ = TDB._nn_descent(TDB._pad_rows(torch.from_numpy(x)), 8,
                               rounds=3, S=4, seed=1, block=None, local=False)
    want_i, want_d = JDB.nn_descent(x, 8, rounds=3, seed=1, S=4)
    assert abs(_knn_recall(fwd_i.numpy(), gt) - _knn_recall(want_i, gt)) <= 0.01
    got_i, got_d = TDB.nn_descent(x, 8, rounds=3, seed=1, S=4, device="cpu")
    assert got_i.dtype == np.int32 and got_d.dtype == np.float32
    assert np.array_equal(np.isinf(got_d), got_i >= len(x))
    assert _knn_recall(got_i, gt) >= _knn_recall(fwd_i.numpy(), gt)


@pytest.mark.parametrize("local", [pytest.param(False, id="forward"),
                                   pytest.param(True, id="local")])
def test_proposals_are_the_join(local):
    """Each node's proposals, as sets: N(N(i)) ∪ R(i) for the reference's
    forward join; also N(R(i)) and R(N(i)) for the local join; never i
    itself; sentinel n pads."""
    rng = np.random.default_rng(4)
    n, K, S = 30, 6, 4
    ids = rng.integers(0, n + 1, (n, K)).astype(np.int32)
    props = TDB._proposals(torch.from_numpy(ids), n, S, local).numpy()
    assert props.shape == (n, (3 if local else 1) * S * S + S)
    N = [set(int(v) for v in ids[i, :S] if v < n) for i in range(n)]
    Rv = TDB._reverse_lists(torch.from_numpy(ids[:, :S]), n, S).numpy()
    Rs = [set(int(v) for v in Rv[i] if v < n) for i in range(n)]
    for i in range(n):
        want = set().union(*(N[j] for j in N[i])) | Rs[i]
        if local:
            want |= set().union(*(N[j] for j in Rs[i]))
            want |= set().union(*(Rs[j] for j in N[i]))
        want.discard(i)
        assert set(int(v) for v in props[i] if v < n) == want, i


def _dataset(seed, n=48, d=6, K=16):
    """The input generator of tests/test_graph_build_props.py."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids, dd = TGB.brute_knn(x, K)
    return x, ids, dd


@pytest.mark.parametrize("seed,R,alpha,keep_pruned", [
    (0, 4, 1.0, True), (1, 6, 1.2, False), (2, 8, 1.45, True),
    (3, 6, 1.6, False)])
def test_occlusion_prune_device_matches_reference(seed, R, alpha, keep_pruned):
    """(e) Identical adjacency (ids and order): the port's device prune,
    the reference's device prune and the host scan."""
    x, ids, dd = _dataset(seed)
    got = TDB.occlusion_prune_device(x, ids, dd, R, alpha=alpha,
                                     keep_pruned=keep_pruned, device="cpu")
    want = JDB.occlusion_prune_device(x, ids, dd, R, alpha=alpha,
                                      keep_pruned=keep_pruned)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, TGB.occlusion_prune(x, ids, dd, R, alpha=alpha,
                                 keep_pruned=keep_pruned))


@pytest.mark.parametrize("seed,R,keep_pruned", [
    (0, 3, True), (1, 5, False), (2, 5, True), (3, 3, False)])
def test_prune_batch_matches_prune_one(seed, R, keep_pruned):
    """(e) prune_batch row i == prune_one on row i (port and reference),
    and the whole batch equal to the reference's prune_batch."""
    rng = np.random.default_rng(seed)
    B, K = 6, 14
    cv = rng.normal(size=(B, K, 5)).astype(np.float32)
    cd = ((cv - rng.normal(size=(B, 1, 5)).astype(np.float32)) ** 2
          ).sum(-1).astype(np.float32)
    ok = rng.random((B, K)) < 0.7
    got = TDB.prune_batch(cv, cd, R, alpha=1.2, edge_ok=ok,
                          keep_pruned=keep_pruned, device="cpu")
    want = JDB.prune_batch(cv, cd, R, alpha=1.2, edge_ok=ok,
                           keep_pruned=keep_pruned)
    np.testing.assert_array_equal(got, want)
    for i in range(B):
        one = TGB.prune_one(cv[i], cd[i], R, alpha=1.2, edge_ok=ok[i],
                            keep_pruned=keep_pruned)
        np.testing.assert_array_equal(
            one, JGB.prune_one(cv[i], cd[i], R, alpha=1.2, edge_ok=ok[i],
                               keep_pruned=keep_pruned))
        np.testing.assert_array_equal(got[i][got[i] >= 0], one)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_patch_reverse_edges_match_reference(seed):
    """(e) The batched device repair and the host repair, each equal to the
    reference's on the same graph and insert batch."""
    R = 4 + 2 * (seed % 2)
    x, ids, dd = _dataset(seed)
    n = len(x)
    nb = TGB.occlusion_prune(x, ids, dd, R, alpha=1.2)
    src = np.arange(0, n, 7)
    got = TDB.patch_reverse_edges_batched(nb.copy(), x, src, n, R,
                                          alpha=1.2, device="cpu")
    want = JDB.patch_reverse_edges_batched(nb.copy(), x, src, n, R, alpha=1.2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TGB.patch_reverse_edges(nb.copy(), x, src, n, R, alpha=1.2),
        JGB.patch_reverse_edges(nb.copy(), x, src, n, R, alpha=1.2))


@pytest.mark.parametrize("seed,sample", [(0, 2048), (1, 8)])
def test_connect_components_matches_reference(seed, sample):
    """Many components (most edges cut): the same links as the reference,
    with the component samples drawn (``sample`` 8) or taken whole."""
    rng = np.random.default_rng(seed)
    n, R = 400, 4
    x = rng.normal(size=(n, 6)).astype(np.float32)
    nb = rng.integers(0, n, (n, R)).astype(np.int32)
    nb[rng.random((n, R)) < 0.75] = n
    want = JGB.connect_components(nb, x, 0, sample=sample, seed=seed)
    got = TGB.connect_components(nb, x, 0, sample=sample, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert TGB.bfs_reachable(got, n, 0).sum() > TGB.bfs_reachable(nb, n, 0).sum()


def test_greedy_candidates_match_reference():
    x, ids, dd = _dataset(5, n=80)
    nb = TGB.occlusion_prune(x, ids, dd, 6, alpha=1.2)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(4, x.shape[1])).astype(np.float32)
    live = rng.random(len(x)) < 0.8
    got = TGB.greedy_candidates(nb, x, q, 0, ef=12, live=live)
    want = JGB.greedy_candidates(nb, x, q, 0, ef=12, live=live)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_reverse_prune_is_the_host_prune_of_both_directions():
    """The device reverse-edge pass equals the host occlusion prune over
    each node's kept neighbours and in-neighbours, sorted by (distance,
    id); and it leaves fewer nodes without an in-edge."""
    x, ids, dd = _dataset(6, n=300, K=16)
    n, R = len(x), 6
    nb = TGB.occlusion_prune(x, ids, dd, R, alpha=1.2)
    tx = TDB._pad_rows(torch.from_numpy(x))
    got = TDB._reverse_prune(tx, torch.from_numpy(nb), R, alpha=1.2).numpy()
    rev = TDB._reverse_lists(torch.from_numpy(nb), n, R).numpy()
    cand = np.full((n, 2 * R), n, np.int32)
    cd = np.full((n, 2 * R), np.inf, np.float32)
    for i in range(n):
        c = sorted({int(v) for v in np.concatenate([nb[i], rev[i]]) if v < n},
                   key=lambda v: (float(((x[v] - x[i]) ** 2).sum()), v))
        cand[i, :len(c)] = c
        cd[i, :len(c)] = ((x[c] - x[i]) ** 2).sum(-1)
    np.testing.assert_array_equal(
        got, TGB.occlusion_prune(x, cand, cd, R, alpha=1.2))
    indeg0 = lambda g: int((np.bincount(g[g < n], minlength=n) == 0).sum())
    assert indeg0(got) < indeg0(nb)


def _graph_invariants(nb, n, R):
    """Degree <= R, ids in [0, n], no self loops, no duplicate edge."""
    real = nb < n
    assert nb.shape[1] == R and (real.sum(axis=1) <= R).all()
    assert (nb >= 0).all() and (nb <= n).all()
    rows = np.broadcast_to(np.arange(n)[:, None], nb.shape)
    assert not (real & (nb == rows)).any(), "self loop"
    for i in range(n):
        kept = nb[i][real[i]]
        assert len(set(kept.tolist())) == len(kept), i


def test_build_graph_dispatch_nn_descent():
    """``build_graph`` hands nn_descent to the device build; that build
    without the port's two steps is the reference's, array for array."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, 12)).astype(np.float32)
    t = {}
    g = TGB.build_graph(x, 8, method="nn_descent", seed=0, device="cpu",
                        timings=t)
    assert g.n == 200 and g.neighbors.shape[1] == 8
    assert set(t) == {"knn", "prune", "reverse_repair"}
    np.testing.assert_array_equal(
        g.neighbors, TDB.build_graph_device(x, 8, seed=0, device="cpu").neighbors)
    want = JGB.build_graph(x, 8, method="nn_descent", seed=0, repair=False)
    got = TDB.build_graph_device(x, 8, seed=0, device="cpu", repair=False,
                                 _reference=True)
    np.testing.assert_array_equal(got.neighbors, want.neighbors)


@pytest.fixture(scope="module")
def nn_descent_case():
    ds = synthetic_vectors(2000, 32, n_queries=64, seed=3)
    kw = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=512,
              build_method="nn_descent")
    ref = JPilotANNIndex(JIndexConfig(**kw), ds.vectors)
    gt = brute_force_topk(ds.vectors, ds.queries, 10)
    want = recall_at_k(np.asarray(ref.search(ds.queries, JSearchParams(
        k=10, ef=48, ef_pilot=48))[0]), gt, 10)
    return ds, kw, gt, want


def test_nn_descent_index_matches_reference(nn_descent_case):
    """(f) ``build_method="nn_descent"`` through the engine on the CPU:
    graph invariants, and search recall@10 within 0.01 of the reference's
    nn_descent index at the same seed."""
    ds, kw, gt, want = nn_descent_case
    idx = PilotANNIndex(IndexConfig(**kw), ds.vectors, device="cpu")
    _graph_invariants(idx.full_graph.neighbors, idx.n, 16)
    sub = idx.sub_graph.neighbors[idx.keep_ids]
    assert np.isin(sub[sub < idx.n], idx.keep_ids).all()
    assert set(idx.build_seconds["full_graph"]) == {"knn", "prune",
                                                    "reverse_repair"}
    got = recall_at_k(idx.search(ds.queries, SearchParams(
        k=10, ef=48, ef_pilot=48))[0], gt, 10)
    assert abs(got - want) <= 0.01, (got, want)
    assert got >= 0.9, got
