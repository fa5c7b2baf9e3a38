"""A model of K6's merge (``csrc/topk.cu``, ``csrc/sort.cuh``) on the CPU,
held against the JAX reference's ``expand_merge_ref`` and the port's plain
version (``kernels/ref.expand_merge_ref``).

The kernel scores the candidates in ``kernels/ref.lane_dot``'s order, as
the plain version does, so the model takes the plain version's scores
(``ref.lane_sq``) and models what the kernel does after them, step for
step, vectorised over the queries:

* the fast route (R <= 32 and a beam sorted by (distance, id)): the
  32-lane shuffle bitonic network over the candidates (padding lanes
  (+inf, INT_MAX)), then each item written to its rank, each count a
  binary search of the other sorted list (beam items count the candidates
  strictly before them by (distance, id); candidates the beam items not
  after them);
* the sort route (R > 32, or a beam out of order or holding a NaN): the
  block-wide bitonic network over W = next_pow2(ef + R) items (padding
  (NaN, INT_MAX) past every real item), the first ef written out.

Ids and checked flags must equal both references exactly, distances the
port's plain version bit for bit (the JAX reference sums with einsum; on
the small-integer inputs below every sum is exact, so it too is equal).
Most cases use small-integer vectors and distances, so ties in (distance,
id) are everywhere: the order of ties is what the kernel can get wrong.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ref import expand_merge_ref as j_expand_merge_ref
from repro_torch.kernels import ref as TR

BIG = np.float32(3.0e38)
INT_MAX = np.iinfo(np.int32).max


def _less(a, b):
    """(distance, id, position) strictly ascending; floats compare as
    floats, so -0.0 == +0.0, and a NaN sorts after every number and ties
    with any other NaN (``ByDistId`` in csrc/sort.cuh)."""
    (da, ia, pa), (db, ib, pb) = a[:3], b[:3]
    na, nb = np.isnan(da), np.isnan(db)
    tie = (da == db) | (na & nb)
    return (np.where(na | nb, nb & ~na, da < db)
            | (tie & ((ia < ib) | ((ia == ib) & (pa < pb)))))


def _before(da, ia, db, ib):
    """(distance, id) strictly before (``before`` in csrc/topk.cu)."""
    return (da < db) | ((da == db) & (ia < ib))


def _bitonic(items):
    """The bitonic network on the last axis (a power of two) as lanes: lane
    i trades with lane i ^ j; the lower lane of a pair keeps the smaller
    item in an ascending run (i & k == 0), the larger in a descending one.
    ``items`` is (d, id, pos, flag), each (B, W)."""
    W = items[0].shape[1]
    lane = np.arange(W)
    k = 2
    while k <= W:
        j = k // 2
        while j > 0:
            other = tuple(x[:, lane ^ j] for x in items)
            up = (lane & k) == 0
            lower = (lane & j) == 0
            take = np.where(lower == up, _less(other, items),
                            _less(items, other))
            items = tuple(np.where(take, o, x) for o, x in zip(other, items))
            j //= 2
        k *= 2
    return items


def _prefix(pred_at, shape, N):
    """Per item, the length of the true prefix of ``pred_at(mid)`` over
    0 .. N - 1: the kernel's binary search, vectorised."""
    lo = np.zeros(shape, np.int64)
    hi = np.full(shape, N, np.int64)
    while (lo < hi).any():
        active = lo < hi
        mid = (lo + hi) // 2
        p = pred_at(np.minimum(mid, max(N - 1, 0)))
        lo = np.where(active & p, mid + 1, lo)
        hi = np.where(active & ~p, mid, hi)
    return lo


def kernel_model(q, nvecs, nids, fresh, beam_id, beam_d, beam_ck, n):
    """K6 on numpy inputs; returns (ids, dists, checked, route)."""
    B, ef = beam_id.shape
    R = nids.shape[1]
    dist = TR.lane_sq(torch.from_numpy(q), torch.from_numpy(nvecs)).numpy()
    cd = np.where(fresh, dist, BIG).astype(np.float32)
    ci = np.where(fresh, nids, n).astype(np.int64)
    cf = (~fresh).astype(np.int64)
    cp = np.broadcast_to(ef + np.arange(R), (B, R))
    bd, bi = beam_d.astype(np.float32), beam_id.astype(np.int64)
    bp = np.broadcast_to(np.arange(ef), (B, ef))
    bf = beam_ck.astype(np.int64)
    # each item against the next: in order only if the compares hold, so
    # a NaN on either side counts as out of order; a beam of one item is
    # tested alone
    in_order = ((bd[:, :-1] < bd[:, 1:])
                | ((bd[:, :-1] == bd[:, 1:]) & (bi[:, :-1] <= bi[:, 1:])))
    unsorted = (~in_order).any() or np.isnan(bd[:, -1]).any()
    if R > 32 or unsorted:
        W = 1 << max(1, (ef + R - 1).bit_length())
        pad = W - ef - R
        padp = np.broadcast_to(ef + R + np.arange(pad), (B, pad))
        items = (np.concatenate([bd, cd, np.full((B, pad), np.nan,
                                                 np.float32)], 1),
                 np.concatenate([bi, ci, np.full((B, pad), INT_MAX)], 1),
                 np.concatenate([bp, cp, padp], 1),
                 np.concatenate([bf, cf, np.ones((B, pad), np.int64)], 1))
        d_, i_, _, f_ = _bitonic(items)
        return i_[:, :ef], d_[:, :ef], f_[:, :ef] != 0, "sort"

    # fast route: the warp sort of the candidates (32 lanes, padding after)
    pad = 32 - R
    padp = np.broadcast_to(ef + R + np.arange(pad), (B, pad))
    sd, si, sp, sf = _bitonic((
        np.concatenate([cd, np.full((B, pad), np.inf, np.float32)], 1),
        np.concatenate([ci, np.full((B, pad), INT_MAX)], 1),
        np.concatenate([cp, padp], 1),
        np.concatenate([cf, np.ones((B, pad), np.int64)], 1)))
    sd, si, sp, sf = (x[:, :R] for x in (sd, si, sp, sf))
    assert (sp >= ef).all() and (sp < ef + R).all()
    rows = np.arange(B)[:, None]
    # beam item i: i + #{candidates strictly before it by (distance, id)}
    nb = _prefix(lambda m: _before(sd[rows, m], si[rows, m], bd, bi),
                 (B, ef), R)
    rank_b = np.arange(ef) + nb
    # candidate j: j + #{beam items not after it}
    nc = _prefix(lambda m: ~_before(sd, si, bd[rows, m], bi[rows, m]),
                 (B, R), ef)
    rank_c = np.arange(R) + nc
    ranks = np.concatenate([rank_b, rank_c], 1)
    assert (np.sort(ranks, 1) == np.arange(ef + R)).all()   # a permutation
    od = np.empty((B, ef), np.float32)
    oi = np.empty((B, ef), np.int64)
    of = np.empty((B, ef), np.int64)
    for src_d, src_i, src_f, rank in ((bd, bi, bf, rank_b),
                                      (sd, si, sf, rank_c)):
        keep = rank < ef
        r, c = np.nonzero(keep)
        od[r, rank[r, c]] = src_d[r, c]
        oi[r, rank[r, c]] = src_i[r, c]
        of[r, rank[r, c]] = src_f[r, c]
    return oi, od, of != 0, "fast"


def _case(B, R, ef, d, seed, integer=True, n=40):
    """Small-integer vectors and sorted small-integer beam distances (ties
    everywhere, every sum exact), ids from a small range (duplicates), the
    last quarter of the beam sentinels."""
    rng = np.random.default_rng(seed)
    draw = ((lambda s: rng.integers(-2, 3, s).astype(np.float32)) if integer
            else (lambda s: rng.normal(size=s).astype(np.float32)))
    q = draw((B, d))
    nv = draw((B, R, d))
    nid = rng.integers(0, n, (B, R)).astype(np.int32)
    fresh = rng.random((B, R)) < 0.6
    bd = np.sort(rng.integers(0, 3 * d, (B, ef)).astype(np.float32), 1)
    if not integer:
        bd = np.sort(rng.random((B, ef)).astype(np.float32) * 2 * d, 1)
    bid = rng.integers(0, n, (B, ef)).astype(np.int32)
    o = np.lexsort((bid, bd), axis=1)
    bd, bid = np.take_along_axis(bd, o, 1), np.take_along_axis(bid, o, 1)
    bck = rng.random((B, ef)) < 0.5
    s = ef - ef // 4
    bid[:, s:], bd[:, s:], bck[:, s:] = n, BIG, False
    return [q, nv, nid, fresh, bid, bd, bck, n]


def _check(args, route, exact=True):
    *arrs, n = args
    gi, gd, gc, got_route = kernel_model(*arrs, n)
    assert got_route == route
    wi, wd, wc = TR.expand_merge_ref(*(torch.from_numpy(a) for a in arrs), n)
    np.testing.assert_array_equal(gi, wi.numpy())
    np.testing.assert_array_equal(gc, wc.numpy())
    np.testing.assert_array_equal(gd.view(np.int32), wd.numpy().view(np.int32))
    ji, jd, jc = (np.asarray(x) for x in
                  j_expand_merge_ref(*(jnp.asarray(a) for a in arrs), n))
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_array_equal(gc, jc)
    if exact:
        np.testing.assert_array_equal(gd, jd)
    else:   # normal vectors: einsum against lane order, float noise
        np.testing.assert_allclose(gd, jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,R,ef,d,integer,route", [
    (16, 32, 128, 48, True, "fast"),     # the stage-① widths
    (16, 5, 20, 48, True, "fast"),       # ef + R = 25, not a power of two
    (16, 32, 16, 24, True, "fast"),      # ef < R
    (16, 32, 64, 48, False, "fast"),     # normal vectors: few ties
    (16, 48, 64, 24, True, "sort"),      # R > 32
])
def test_model_matches_both_references(B, R, ef, d, integer, route):
    _check(_case(B, R, ef, d, seed=B + R + ef, integer=integer), route,
           exact=integer)


def test_model_sentinel_ties():
    """Beam sentinels (BIG and +inf, id n, unchecked) tie on (distance,
    id) with the candidates that are not fresh (BIG, id n, checked); with
    few fresh candidates the ties reach the first ef slots, where only the
    position tells the flags apart."""
    args = _case(16, 32, 48, 24, seed=3)
    fresh, bd = args[3], args[5]
    fresh &= np.random.default_rng(4).random(fresh.shape) < 0.3
    bd[:, -4:] = np.inf
    _check(args, "fast")


def test_model_duplicate_ids_and_planted_ties():
    """Candidates that repeat an id, and beam items equal in (distance, id)
    to a fresh candidate: the beam item goes first."""
    args = _case(8, 32, 32, 24, seed=5)
    q, nv, nid, fresh, bid, bd, bck, n = args
    nid[:, 1::2] = nid[:, ::2]
    fresh[:, :4] = True
    dist = TR.lane_sq(torch.from_numpy(q), torch.from_numpy(nv)).numpy()
    bd[:, 0], bid[:, 0] = dist[:, 0], nid[:, 0]
    bd[:, 1], bid[:, 1] = dist[:, 3], nid[:, 3]
    o = np.lexsort((bid, bd), axis=1)
    args[5][:] = np.take_along_axis(bd, o, 1)
    args[4][:] = np.take_along_axis(bid, o, 1)
    args[6][:] = np.take_along_axis(bck, o, 1)
    _check(args, "fast")


def test_model_negative_zero_beside_positive_zero():
    """-0.0 and +0.0 in the beam compare equal (the beam counts as sorted),
    and candidates at distance exactly 0 (rows equal to q) tie with them."""
    args = _case(8, 32, 32, 16, seed=6)
    q, nv, nid, fresh, bid, bd, bck, n = args
    nv[:, :6] = q[:, None, :]
    fresh[:, :6] = True
    bd[:, :6] = np.array([-0.0, 0.0, -0.0, 0.0, 0.0, -0.0], np.float32)
    bid[:, :6] = np.array([1, 3, 3, 7, 9, 12], np.int32)
    bd[:, 6:] = np.maximum(bd[:, 6:], 1.0)
    o = np.lexsort((bid, bd), axis=1)
    args[4][:] = np.take_along_axis(bid, o, 1)
    args[5][:] = np.take_along_axis(bd, o, 1)
    _check(args, "fast")


def test_model_unsorted_beam_takes_the_sort_route():
    """A beam out of (distance, id) order, even by one swapped id, goes to
    the block sort, which sorts it with the candidates."""
    args = _case(16, 32, 64, 24, seed=7)
    bid, bd = args[4], args[5]
    bd[:, :48] = np.arange(48, dtype=np.float32)
    bd[:, 3] = 2.0
    bid[:, 2], bid[:, 3] = 9, 4
    _check(args, "sort")
    rng = np.random.default_rng(8)
    perm = rng.permuted(np.tile(np.arange(64), (16, 1)), axis=1)
    for i in (4, 5, 6):
        args[i][:] = np.take_along_axis(args[i], perm, 1)
    _check(args, "sort")


def test_model_nan_in_the_beam_takes_the_sort_route():
    """A NaN beam distance (stage-0 distances are not clamped) sends the
    beam to the block sort, where a NaN sorts after every number, +inf
    sentinels included, and ahead of the padding: with R 2 and few fresh
    candidates the NaN items reach the first ef slots, in id order.  A beam
    of one NaN item is caught too."""
    args = _case(16, 2, 16, 8, seed=9)
    bd, bid = args[5], args[4]
    bd[:, 3], bd[:, 5], bd[:, 9] = np.nan, np.nan, -np.float32(np.nan)
    bd[::2, 13:] = np.inf
    bid[:, 5] = 0
    _check(args, "sort")
    # a beam of one NaN item: no pair to compare, so it is tested alone
    args = _case(16, 2, 1, 8, seed=10)
    args[5][:, 0] = np.nan
    _check(args, "sort")
