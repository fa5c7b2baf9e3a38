"""PyTorch port vs the JAX reference: bloom filters and greedy traversal.

The same numpy inputs (from a seed) go through ``repro.core`` (jnp, CPU)
and ``repro_torch.core`` (torch, CPU).  Ids, checked flags, visited bits
and all three counters must match exactly; distances within
rtol=1e-5, atol=1e-5 (the reference's own kernels differ from their
oracles by about 1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bloom as JB
from repro.core import traversal as JT
from repro_torch.core import bloom as TB
from repro_torch.core import traversal as TT

# Small tensors and many ops: one intra-op thread is faster, and leaves the
# cores to the other pytest workers of a parallel run.
torch.set_num_threads(1)


# the reference's functions, jitted: one compile per shape instead of one
# per eager op (same outputs)
_j_greedy_search = jax.jit(JT.greedy_search, static_argnums=(0, 4),
                           static_argnames=("iters",))
_j_init_state = jax.jit(JT.init_state, static_argnums=(0, 4))


def _random_index(n, R, d, seed):
    """Random regular digraph + random vectors (padded tables)."""
    rng = np.random.default_rng(seed)
    nbr = np.stack([rng.choice(n, R, replace=False) for _ in range(n)])
    nbr_t = np.concatenate([nbr, np.full((1, R), n)]).astype(np.int32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    vec_t = np.concatenate([x, np.zeros((1, d), np.float32)])
    return nbr_t, vec_t


def _assert_state_match(got, want):
    """got: torch SearchState; want: jax SearchState."""
    for name in ("cand_id", "checked", "visited", "n_dist", "n_hops",
                 "n_exp"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.cand_d.numpy(), np.asarray(want.cand_d),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# bloom / exact visited tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1024, 16384])
def test_hashes_bit_identical(bits):
    rng = np.random.default_rng(bits)
    ids = rng.integers(0, 1 << 23, (4, 64)).astype(np.int32)
    ids[0, :4] = [0, 1, (1 << 23) - 1, (1 << 31) - 1]
    t1, t2 = TB.hashes(torch.from_numpy(ids), bits)
    j1, j2 = JB.hashes(jnp.asarray(ids), bits)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


@pytest.mark.parametrize("mode", ["bloom", "exact"])
def test_insert_colliding_masked_ids(mode):
    """A bit hit by two ids, one masked in and one masked out (in either
    order), must end up set — the reference's ``.at[...].max(mask)``."""
    n, bits = 500, 256
    ids = np.array([[7, 7, 3, 3, 9, 9, 11],
                    [5, 5, 5, 2, 2, 8, 8]], np.int32)
    mask = np.array([[True, False, False, True, False, False, True],
                     [False, False, True, True, False, False, False]])
    if mode == "bloom":
        t_init, t_ins, t_test = TB.bloom_init(2, bits), TB.bloom_insert, TB.bloom_test
        j_init, j_ins, j_test = JB.bloom_init(2, bits), JB.bloom_insert, JB.bloom_test
    else:
        t_init, t_ins, t_test = TB.exact_init(2, n), TB.exact_insert, TB.exact_test
        j_init, j_ins, j_test = JB.exact_init(2, n), JB.exact_insert, JB.exact_test
    got = t_ins(t_init, torch.from_numpy(ids), torch.from_numpy(mask))
    want = j_ins(j_init, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool(t_init.any())                  # functional: input untouched
    hit = t_test(got, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(hit, np.asarray(j_test(want, jnp.asarray(ids))))
    assert hit[0, 0] and hit[0, 1] and hit[1, 2]   # masked-in ids are set
    if mode == "exact":                            # masked-out ids are not
        assert not hit[0, 4] and not hit[1, 5]


# ---------------------------------------------------------------------------
# greedy_search parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W,mode,iters", [
    (W, mode, None) for W in (1, 2, 4) for mode in ("bloom", "exact")
] + [(2, "bloom", 3), (2, "exact", 3)])
def test_greedy_search_parity(W, mode, iters):
    """Run-to-convergence and fixed-``iters`` searches, through the plain
    round, the per-hop kernel wrapper and the persistent one (both run
    their plain versions on CPU tensors)."""
    rng = np.random.default_rng(11 + W)
    n, R, d, Bq, ef = 1024, 16, 32, 12, 32
    nbr_t, vec_t = _random_index(n, R, d, seed=11)
    q = rng.normal(size=(Bq, d)).astype(np.float32)
    entries = rng.integers(0, n, (Bq, 4)).astype(np.int32)

    want = _j_greedy_search(
        JT.TraversalSpec(ef=ef, visited_mode=mode, bloom_bits=2048,
                         frontier_width=W),
        jnp.asarray(q), jnp.asarray(nbr_t), jnp.asarray(vec_t), n,
        jnp.asarray(entries), iters=iters)
    targs = (torch.from_numpy(q), torch.from_numpy(nbr_t),
             torch.from_numpy(vec_t), n, torch.from_numpy(entries))
    for kernel in ({}, {"use_pallas": True},
                   {"use_pallas": True, "use_persistent": True}):
        spec = TT.TraversalSpec(ef=ef, visited_mode=mode, bloom_bits=2048,
                                frontier_width=W, **kernel)
        got = TT.greedy_search(spec, *targs, iters=iters)
        _assert_state_match(got, want)


@pytest.mark.parametrize("W", [1, 2])
def test_parity_holds_on_tied_distances(W):
    """Duplicate vectors produce exactly tied distances; the stable merge
    must order them as the reference's stable argsort does."""
    rng = np.random.default_rng(21)
    n, R, d, Bq, ef = 512, 8, 8, 8, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[1::2] = x[::2]                       # every node has an exact twin
    nbr = np.stack([rng.choice(n, R, replace=False) for _ in range(n)])
    nbr_t = np.concatenate([nbr, np.full((1, R), n)]).astype(np.int32)
    vec_t = np.concatenate([x, np.zeros((1, d), np.float32)])
    q = x[rng.choice(n, Bq)] + 0.01
    entries = rng.integers(0, n, (Bq, 2)).astype(np.int32)

    want = _j_greedy_search(
        JT.TraversalSpec(ef=ef, visited_mode="exact", frontier_width=W),
        jnp.asarray(q), jnp.asarray(nbr_t), jnp.asarray(vec_t), n,
        jnp.asarray(entries))
    for kernel in ({}, {"use_pallas": True, "use_persistent": True}):
        got = TT.greedy_search(
            TT.TraversalSpec(ef=ef, visited_mode="exact", frontier_width=W,
                             **kernel),
            torch.from_numpy(q), torch.from_numpy(nbr_t),
            torch.from_numpy(vec_t), n, torch.from_numpy(entries))
        _assert_state_match(got, want)


def test_init_state_and_sq_dists_parity():
    """init_state (dedupe by (id, d), stable sort, pad to ef) and the
    norms-minus-2·dot distance form, on entries with repeated ids."""
    rng = np.random.default_rng(5)
    n, d, Bq, ef = 300, 16, 6, 24
    _, vec_t = _random_index(n, 4, d, seed=5)
    q = rng.normal(size=(Bq, d)).astype(np.float32)
    entries = rng.integers(0, 20, (Bq, 12)).astype(np.int32)   # many repeats
    entries[:, -2:] = n                                         # sentinels
    spec_j = JT.TraversalSpec(ef=ef, visited_mode="bloom", bloom_bits=1024)
    spec_t = TT.TraversalSpec(ef=ef, visited_mode="bloom", bloom_bits=1024)
    want = _j_init_state(spec_j, jnp.asarray(q), jnp.asarray(entries),
                         jnp.asarray(vec_t[:-1]), n)
    got = TT.init_state(spec_t, torch.from_numpy(q),
                        torch.from_numpy(entries), torch.from_numpy(vec_t), n)
    _assert_state_match(got, want)
    np.testing.assert_allclose(
        TT.sq_dists(torch.from_numpy(q), torch.from_numpy(vec_t)).numpy(),
        np.asarray(JT.sq_dists(jnp.asarray(q), jnp.asarray(vec_t))),
        rtol=1e-5, atol=1e-5)


def test_tombstone_masking_parity():
    rng = np.random.default_rng(9)
    n, R, d, Bq, ef = 400, 8, 8, 6, 16
    nbr_t, vec_t = _random_index(n, R, d, seed=9)
    q = rng.normal(size=(Bq, d)).astype(np.float32)
    entries = rng.integers(0, n, (Bq, 3)).astype(np.int32)
    tomb = np.zeros(n + 1, bool)
    tomb[rng.choice(n, 60, replace=False)] = True
    want = _j_greedy_search(
        JT.TraversalSpec(ef=ef, visited_mode="exact"), jnp.asarray(q),
        jnp.asarray(nbr_t), jnp.asarray(vec_t), n, jnp.asarray(entries),
        tombstone=jnp.asarray(tomb))
    got = TT.greedy_search(
        TT.TraversalSpec(ef=ef, visited_mode="exact"), torch.from_numpy(q),
        torch.from_numpy(nbr_t), torch.from_numpy(vec_t), n,
        torch.from_numpy(entries), tombstone=torch.from_numpy(tomb))
    _assert_state_match(got, want)
    assert not tomb[got.cand_id.numpy()[got.cand_id.numpy() < n]].any()
