"""PyTorch port vs the JAX reference: the kernels' plain versions and their
wrappers (which run the plain versions on CPU tensors).

The JAX side runs as its own tests run it on the CPU: the pure-jnp oracles
of ``repro.kernels.ref`` and the Pallas kernels in interpret mode.  The
CUDA kernels themselves run only on the card: see
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.fes import build_fes, fes_select_ref as j_fes_select_ref
from repro.kernels import ref as JR
from repro.kernels.fes_kernel import fes_distances as j_fes_distances
from repro.kernels.ops import fes_select as j_fes_select
from repro.kernels.traversal_kernel import (fused_pilot_search as j_pilot,
                                            fused_traversal_hop as j_hop)
from repro_torch.core import bloom as TB
from repro_torch.core.fes import fes_select_ref as t_fes_select_ref
from repro_torch.kernels import fes_kernel, ops, ref as TR, traversal_kernel

# Small tensors and many ops: one intra-op thread is faster, and leaves the
# cores to the other pytest workers of a parallel run.
torch.set_num_threads(1)


def _random_index(n, R, d, seed, id_dtype=np.int32):
    rng = np.random.default_rng(seed)
    nbr = np.stack([rng.choice(n, R, replace=False) for _ in range(n)])
    nbr_t = np.concatenate([nbr, np.full((1, R), n)]).astype(id_dtype)
    x = rng.normal(size=(n, d)).astype(np.float32)
    vec_t = np.concatenate([x, np.zeros((1, d), np.float32)])
    return nbr_t, vec_t


def _random_beam(rng, Bq, ef, n, n_sentinel=3):
    bid = rng.integers(0, n, (Bq, ef)).astype(np.int32)
    bd = np.sort(rng.random((Bq, ef)).astype(np.float32) * 40, axis=1)
    bck = rng.random((Bq, ef)) > 0.6
    bid[:, ef - n_sentinel:] = n
    bd[:, ef - n_sentinel:] = np.inf
    bck[:, ef - n_sentinel:] = True
    return bid, bd, bck


def _hop_inputs(B_, R, ef, d, mode, seed, n=600, id_dtype=np.int32):
    """Seeded inputs; the beam's ids are inserted into the visited table
    with the port's bloom, which ``test_torch_bloom_traversal.py`` holds
    bit-identical to the reference's."""
    rng = np.random.default_rng(seed)
    nbr_t, vec_t = _random_index(n, R, d, seed=7, id_dtype=id_dtype)
    q = rng.normal(size=(B_, d)).astype(np.float32)
    bid, bd, bck = _random_beam(rng, B_, ef, n)
    ids = torch.from_numpy(np.where(bid < n, bid, 0))
    live = torch.from_numpy(bid < n)
    if mode == "bloom":
        vis = TB.bloom_insert(TB.bloom_init(B_, 2048), ids, live)
    else:
        vis = TB.exact_insert(TB.exact_init(B_, n), ids, live)
    return (q, nbr_t, vec_t, bid, bd, bck, vis.numpy()), n


# the reference's oracle, jitted: one compile per shape instead of one per
# eager op (same outputs)
_j_hop_ref = jax.jit(JR.traversal_hop_ref, static_argnums=(7,),
                     static_argnames=("width", "visited_mode"))


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs])


def _assert_outputs_match(got, want):
    """(id, d, ck, vis, ...) — everything exact except the distances."""
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        if i == 1:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"output {i}")


# ---------------------------------------------------------------------------
# K2 / K1: pilot traversal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B_,R,ef,d,W", [
    (8, 8, 16, 16, 1), (32, 16, 32, 32, 2), (64, 32, 48, 64, 1),
    (12, 8, 16, 24, 2),
])
@pytest.mark.parametrize("mode", ["bloom", "exact"])
def test_hop_ref_matches_jax_oracle(B_, R, ef, d, W, mode):
    arrs, n = _hop_inputs(B_, R, ef, d, mode, seed=B_ + R + ef)
    j, t = _both(arrs)
    want = _j_hop_ref(*j, n, width=W, visited_mode=mode)
    _assert_outputs_match(
        TR.traversal_hop_ref(*t, n, width=W, visited_mode=mode), want)
    _assert_outputs_match(           # the wrapper takes the plain path on CPU
        traversal_kernel.fused_traversal_hop(*t, n, width=W,
                                             visited_mode=mode), want)


@pytest.mark.parametrize("mode", ["bloom", "exact"])
def test_hop_matches_interpret_kernel(mode):
    arrs, n = _hop_inputs(8, 8, 16, 16, mode, seed=3)
    j, t = _both(arrs)
    want = j_hop(*j, n, width=2, visited_mode=mode, interpret=True)
    _assert_outputs_match(
        TR.traversal_hop_ref(*t, n, width=2, visited_mode=mode), want)


@pytest.mark.parametrize("B_,W,mode", [(10, 1, "bloom"), (16, 2, "exact"),
                                       (7, 4, "bloom")])
def test_pilot_search_ref_matches_jax_oracle(B_, W, mode):
    """Ragged batches (B not a multiple of anything) run to convergence."""
    arrs, n = _hop_inputs(B_, 8, 16, 16, mode, seed=31 + W)
    j, t = _both(arrs)
    want = JR.pilot_search_ref(*j, n, rounds=64, width=W, visited_mode=mode)
    _assert_outputs_match(
        TR.pilot_search_ref(*t, n, rounds=64, width=W, visited_mode=mode),
        want)
    _assert_outputs_match(
        traversal_kernel.fused_pilot_search(*t, n, rounds=64, width=W,
                                            visited_mode=mode), want)


def test_pilot_search_matches_interpret_kernel():
    arrs, n = _hop_inputs(10, 8, 16, 16, "exact", seed=13)
    j, t = _both(arrs)
    want = j_pilot(*j, n, rounds=64, width=2, visited_mode="exact",
                   interpret=True)
    _assert_outputs_match(
        TR.pilot_search_ref(*t, n, rounds=64, width=2, visited_mode="exact"),
        want)


@pytest.mark.parametrize("mode", ["bloom", "exact"])
def test_int16_neighbour_tables(mode):
    """Compact pilot ids stored int16 give the same results as int32."""
    arrs16, n = _hop_inputs(12, 8, 16, 16, mode, seed=5, id_dtype=np.int16)
    arrs32 = list(arrs16)
    arrs32[1] = arrs16[1].astype(np.int32)
    j, _ = _both(arrs32)
    _, t = _both(arrs16)
    assert t[1].dtype == torch.int16
    _assert_outputs_match(
        TR.traversal_hop_ref(*t, n, width=2, visited_mode=mode),
        _j_hop_ref(*j, n, width=2, visited_mode=mode))
    _assert_outputs_match(
        TR.pilot_search_ref(*t, n, rounds=64, visited_mode=mode),
        JR.pilot_search_ref(*j, n, rounds=64, visited_mode=mode))


def test_lane_dot_is_a_dot_product():
    rng = np.random.default_rng(0)
    for d in (1, 16, 32, 48, 96, 130):
        a = torch.from_numpy(rng.normal(size=(5, 3, d)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(5, 1, d)).astype(np.float32))
        np.testing.assert_allclose(TR.lane_dot(a, b).numpy(),
                                   (a.double() * b.double()).sum(-1).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_plain_bloom_matches_reference_filter_layout():
    """The wrappers keep the reference's (B, bits) bool layout."""
    ids = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    f = TB.bloom_insert(TB.bloom_init(1, 64), ids, torch.ones_like(ids, dtype=torch.bool))
    assert f.dtype == torch.bool and f.shape == (1, 64)


# ---------------------------------------------------------------------------
# K3: FES distances and the fes_select wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,QC,C,d", [
    (2, 4, 128, 64), (4, 8, 128, 128), (8, 16, 256, 256),
    (32, 8, 128, 384), (1, 32, 512, 128),
])
def test_fes_distances_ref_matches_interpret_kernel(r, QC, C, d):
    rng = np.random.default_rng(42)
    qg = rng.normal(size=(r, QC, d)).astype(np.float32)
    ev = rng.normal(size=(r, C, d)).astype(np.float32)
    want = np.asarray(j_fes_distances(jnp.asarray(qg), jnp.asarray(ev),
                                      interpret=True))
    for fn in (TR.fes_distances_ref, fes_kernel.fes_distances):
        got = fn(torch.from_numpy(qg), torch.from_numpy(ev))
        assert got.dtype == torch.float32 and got.shape == (r, QC, C)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * d)


@pytest.mark.parametrize("r,L", [(4, 4), (8, 8), (16, 16)])
def test_fes_select_matches_reference(r, L):
    rng = np.random.default_rng(r)
    n, d = 4000, 48
    x = rng.normal(size=(n, d)).astype(np.float32)
    idx = build_fes(x, np.arange(n), r=r, n_entry=1024, align=128, seed=1)
    q = rng.normal(size=(64, d)).astype(np.float32)
    arrs = (idx.centroids, idx.entries, idx.entry_ids, idx.valid)
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    ids1, d1 = j_fes_select(jnp.asarray(q), *j, L=L, interpret=True)
    ids2, d2 = j_fes_select_ref(jnp.asarray(q), *j, L)
    got_ops = ops.fes_select(torch.from_numpy(q), *t, L=L)
    got_ref = t_fes_select_ref(torch.from_numpy(q), *t, L)
    np.testing.assert_array_equal(got_ops[0].numpy(), np.asarray(ids1))
    np.testing.assert_array_equal(got_ref[0].numpy(), np.asarray(ids2))
    np.testing.assert_allclose(got_ops[1].numpy(), np.asarray(d1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_ref[1].numpy(), np.asarray(d2),
                               rtol=1e-4, atol=1e-4)


def test_fes_select_ragged_batch_and_capacity():
    """B = 13 and a per-cluster capacity below the busiest cluster: dropped
    queries come back as zeros / +inf, as in the reference."""
    rng = np.random.default_rng(2)
    n, d, r, L = 2000, 24, 4, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    idx = build_fes(x, np.arange(n), r=r, n_entry=512, align=128, seed=2)
    q = rng.normal(size=(13, d)).astype(np.float32)
    arrs = (idx.centroids, idx.entries, idx.entry_ids, idx.valid)
    for qc in (None, 2):
        ids1, d1 = j_fes_select(jnp.asarray(q), *[jnp.asarray(a) for a in arrs],
                                L=L, qc=qc, interpret=True)
        got = ops.fes_select(torch.from_numpy(q),
                             *[torch.from_numpy(a) for a in arrs], L=L, qc=qc)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ids1))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(d1),
                                   rtol=1e-4, atol=1e-4)
