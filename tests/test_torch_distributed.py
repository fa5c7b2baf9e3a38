"""The port's pod layer (``core/distributed.py``) against the reference's:
``PodIndexSpec`` sizing, ``pod_array_specs`` / ``pod_shardings`` layout,
the shard hooks' owner select, and the dry-run ``make_pod_search_step``
(``tests/test_distributed.py``'s set-up, in-process: the port's meshes are
lists of ``torch.device``s, so no forced host devices are needed)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexConfig as JIndexConfig
from repro.core import PilotANNIndex as JPilotANNIndex
from repro.core import SearchParams as JSearchParams
from repro.core import brute_force_topk, recall_at_k
from repro.core import distributed as JD
from repro.data import synthetic_vectors
from repro.launch.mesh import _auto_axis_kwargs
from repro_torch.core import (IndexConfig, SearchParams,
                              ShardedSegmentedIndex, ShardParams)
from repro_torch.core import distributed as D
from repro_torch.core import traversal as T

torch.set_num_threads(1)

DTYPES = ("float32", "bfloat16", "int8", "int4", "pq")


def _mesh(shape, axes=("data", "model")):
    return D.PodMesh(np.array(["cpu"] * int(np.prod(shape)),
                              dtype=object).reshape(shape), axes)


# ---------------------------------------------------------------------------
# sizing and layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mutable", [False, True])
@pytest.mark.parametrize("pilot_dtype", DTYPES)
def test_pod_index_spec_bytes_like_reference(pilot_dtype, mutable):
    kw = dict(n=1_000_000, d=96, d_primary=48, R=32, n_pilot=250_000,
              pilot_dtype=pilot_dtype, mutable=mutable)
    got, want = D.PodIndexSpec(**kw), JD.PodIndexSpec(**kw)
    assert got.pilot_bytes() == want.pilot_bytes()
    assert got.full_bytes() == want.full_bytes()
    assert got.delta_bytes() == want.delta_bytes()
    assert (got.delta_bytes() > 0) == mutable


@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.parametrize("mutable", [False, True])
@pytest.mark.parametrize("pilot_dtype", DTYPES)
def test_pod_array_specs_like_reference(pilot_dtype, mutable, n_dev):
    # the reference reads only ``mesh.devices.shape``: a stand-in of n_dev
    # devices sizes it without n_dev JAX devices
    kw = dict(n=10_001, d=96, d_primary=48, R=32, n_pilot=2_500,
              fes_capacity=64, query_batch=16, pilot_dtype=pilot_dtype,
              mutable=mutable, n_delta_segments=2, delta_capacity=128)
    shape = (2, 4) if n_dev == 8 else (1, 1)
    got = D.pod_array_specs(D.PodIndexSpec(**kw), _mesh(shape))
    want = JD.pod_array_specs(JD.PodIndexSpec(**kw), types.SimpleNamespace(
        devices=np.empty(shape)))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).replace("torch.", "") == \
            np.dtype(want[k].dtype).name, k
    assert got["full_vecs"].shape[0] % n_dev == 0


@pytest.mark.parametrize("mutable", [False, True])
def test_pod_shardings_like_reference(mutable):
    spec = dict(n=1023, mutable=mutable)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), **_auto_axis_kwargs(2))
    for cax in (None, ("model",)):
        got = D.pod_shardings(D.PodIndexSpec(**spec), _mesh((2, 4)),
                              corpus_axes=cax)
        want = JD.pod_shardings(JD.PodIndexSpec(**spec), jmesh,
                                corpus_axes=cax)
        assert got.keys() == want.keys()
        for k, pl in got.items():
            ws = tuple(want[k].spec)
            axes = (ws[0],) if ws and isinstance(ws[0], str) else \
                tuple(ws[0]) if ws else ()
            assert pl.axes == axes, k


def test_pod_mesh_axis_devices():
    devs = np.array([f"cpu:{i}" for i in range(8)], dtype=object)
    mesh = D.PodMesh(devs.reshape(2, 4), ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 4}
    idx = lambda ds: [d.index for d in ds]
    assert idx(mesh.axis_devices(("model",))) == [0, 1, 2, 3]
    assert idx(mesh.axis_devices(("data",))) == [0, 4]
    assert idx(mesh.axis_devices(("data", "model"))) == list(range(8))
    assert idx(mesh.axis_devices(("model", "data"))) == \
        [0, 4, 1, 5, 2, 6, 3, 7]
    with pytest.raises(ValueError, match="axis names"):
        D.PodMesh(devs.reshape(2, 4), ("data",))


def test_shard_params_and_device_hint():
    with pytest.raises(ValueError, match="placement"):
        ShardParams(placement="sharded")
    with pytest.raises(ValueError, match="n_shards"):
        ShardParams(n_shards=0)
    x = np.zeros((64, 8), np.float32)
    with pytest.raises(ValueError, match=r"\['cpu'\] \* 3"):
        ShardedSegmentedIndex(IndexConfig(), x,
                              shard_params=ShardParams(n_shards=3),
                              devices=["cpu", "cpu"])


# ---------------------------------------------------------------------------
# the hooks: owner computes, the owner's value is selected
# ---------------------------------------------------------------------------

def test_owner_select_keeps_negative_zero():
    # a psum of the owner's -0.0 with another shard's exact 0.0 is +0.0; the
    # select hands the owner's bits through
    own = torch.tensor([-0.0, 1.5])
    other = torch.tensor([0.0, 0.0])
    got = D.owner_select([own, other], torch.tensor([0, 0]))
    assert torch.equal(got.view(torch.int32), own.view(torch.int32))
    assert not torch.equal((own + other).view(torch.int32),
                           own.view(torch.int32))


@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_shard_hooks_equal_the_gather(K):
    g = torch.Generator().manual_seed(K)
    n, d, R = 37, 12, 5
    vecs = torch.randn(n + 1, d, generator=g)
    nbrs = torch.randint(0, n + 1, (n + 1, R), generator=g, dtype=torch.int32)
    Np = D._round_to(n + 1, K)
    rp = Np // K
    vs = D._row_shards(vecs, Np, 0, ["cpu"] * K)
    ns = D._row_shards(nbrs, Np, n, ["cpu"] * K)
    assert sum(v.shape[0] for v in vs) == Np
    q = torch.randn(6, d, generator=g)
    ids = torch.randint(0, n + 1, (6, 9), generator=g, dtype=torch.int32)
    got = D.shard_local_dist_fn(vs, rp)(q, ids)
    want = T.sq_dists(q, vecs[ids.long()])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    u = ids[:, 0]
    assert torch.equal(D.shard_local_nbr_fn(ns, rp)(u), nbrs[u.long()])
    rows = D._gather_rows(vs, ids, rp)
    assert torch.equal(rows, vecs[ids.long()])


# ---------------------------------------------------------------------------
# the dry-run pod step (tests/test_distributed.py's set-up)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pod_case():
    ds = synthetic_vectors(2048, 16, n_queries=64, seed=0)
    idx = JPilotANNIndex(JIndexConfig(R=8, sample_ratio=0.4, svd_ratio=0.5,
                                      n_entry=512, fes_clusters=4,
                                      build_method="exact"), ds.vectors)
    n, dp, R = idx.n, idx.reducer.d_primary, 8
    keep_ids = idx.keep_ids
    compact = np.full(n + 1, len(keep_ids), np.int32)
    compact[keep_ids] = np.arange(len(keep_ids))
    pilot_nb = np.full((len(keep_ids) + 1, R), len(keep_ids), np.int32)
    for c, i in enumerate(keep_ids):
        row = idx.sub_graph.neighbors[i]
        row = row[row < n]
        pilot_nb[c, :len(row)] = compact[row]
    rot = np.asarray(idx.arrays["rot_vecs"])[:-1]
    Npad = ((n + 1 + 7) // 8) * 8
    full_nb = np.full((Npad, R), Npad - 1, np.int32)
    fg = idx.full_graph.neighbors[:, :R]
    full_nb[:n] = np.where(fg < n, fg, Npad - 1)
    full_vecs = np.zeros((Npad, rot.shape[1]), np.float32)
    full_vecs[:n] = rot
    fes = idx.fes_index
    arrays = dict(
        pilot_neighbors=pilot_nb,
        pilot_vecs=np.concatenate([rot[keep_ids][:, :dp],
                                   np.zeros((1, dp), np.float32)], 0),
        pilot_scale=np.ones(dp, np.float32),
        pilot_to_full=np.concatenate([keep_ids, [n]]).astype(np.int32),
        fes_centroids=np.array(fes.centroids),
        fes_entries=np.array(fes.entries),
        fes_scale=np.ones(dp, np.float32),
        fes_entry_ids=compact[fes.entry_ids], fes_valid=np.array(fes.valid),
        full_neighbors=full_nb, full_vecs=full_vecs,
        queries=np.asarray(idx.rotate_queries(ds.queries)))
    kw = dict(n=Npad - 1, d=rot.shape[1], d_primary=dp, R=R,
              n_pilot=len(keep_ids), fes_r=fes.centroids.shape[0],
              fes_capacity=fes.entries.shape[1], query_batch=64, ef_pilot=16,
              ef=16, pilot_iters=24, final_iters=24, bloom_bits=4096)
    sp = dict(k=10, ef=16, ef_pilot=16, fes_L=8, bloom_bits=4096)
    # the reference's step on a one-device JAX mesh, both gather modes
    jmesh = jax.make_mesh((1, 1), ("data", "model"), **_auto_axis_kwargs(2))
    ref = {}
    with jmesh:
        for mode, cax, qspec in (("naive", ("data", "model"), None),
                                 ("shardwise", ("model",),
                                  jax.sharding.PartitionSpec("data", None))):
            fn = JD.make_pod_search_step(
                JD.PodIndexSpec(**kw), JSearchParams(**sp), gather_mode=mode,
                unroll=False, mesh=jmesh, corpus_axes=cax, query_spec=qspec)
            ref[mode] = np.asarray(jax.jit(fn)(
                *[jnp.asarray(v) for v in arrays.values()])[0])
    gt = brute_force_topk(ds.vectors, ds.queries, 10)
    return dict(arrays=arrays, kw=kw, sp=sp, n=n, ref=ref, gt=gt)


def _port_step(case, shape, mode):
    cax = ("data", "model") if mode == "naive" else ("model",)
    mesh = _mesh(shape)
    spec = D.PodIndexSpec(**case["kw"])
    placed = D.place_arrays(
        {k: torch.tensor(v) for k, v in case["arrays"].items()},
        D.pod_shardings(spec, mesh, corpus_axes=cax), mesh)
    shards = {(2, 4): 8 if mode == "naive" else 4, (1, 1): 1}[shape]
    assert len(placed["full_vecs"]) == shards
    fn = D.make_pod_search_step(spec, SearchParams(**case["sp"]),
                                gather_mode=mode, mesh=mesh, corpus_axes=cax,
                                query_spec=("data",))
    ids, dists = fn(**placed)
    return ids.numpy(), dists.numpy()


@pytest.mark.parametrize("mode", ["naive", "shardwise"])
def test_pod_search_step_matches_reference_and_one_device(pod_case, mode):
    ids, dists = _port_step(pod_case, (2, 4), mode)
    one_ids, one_d = _port_step(pod_case, (1, 1), "naive")
    other = _port_step(pod_case, (2, 4),
                       "shardwise" if mode == "naive" else "naive")
    for i, d in ((one_ids, one_d), other):
        np.testing.assert_array_equal(ids, i)
        np.testing.assert_array_equal(dists.view(np.int32), d.view(np.int32))
    np.testing.assert_array_equal(ids, pod_case["ref"][mode])
    n = pod_case["n"]
    assert recall_at_k(np.where(ids < n, ids, 0), pod_case["gt"], 10) >= 0.7


def test_pod_search_step_rejects_unknown_mode():
    with pytest.raises(ValueError, match="gather_mode"):
        D.make_pod_search_step(D.PodIndexSpec(), gather_mode="allgather")
