"""K7's threshold filter, written in numpy, against the plain merge.

The candidate-merge kernel (``csrc/build.cu``) orders and dedupes a row's
K incumbents; when they hold K distinct valid ids, the K-th (distance, id)
key is a threshold, and only the proposals below it (and, for an id already
held, below the incumbent's key) are merged.  This file holds that rule on
the CPU, where the kernel cannot run:

* merging only the survivors with ``kernels/ref.candidate_merge_ref`` gives
  the full merge's ids and distance bits exactly;
* a numpy model of the kernel's steps (64-bit keys with -0.0 folded to
  +0.0, (position, -0.0) tags, an id-major and a distance-major sort, and
  the one-by-one insertion of a few survivors into sorted incumbents)
  gives them too.

Rows are seeded random and adversarial: unsorted incumbents with repeats,
ties at the threshold, ids >= n and negative ids, -0.0 beside +0.0,
negative and infinite distances, all-sentinel incumbents, no proposals.
The kernel itself is held against the plain merge on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import BIG, candidate_merge_ref

torch.set_num_threads(1)

NEG0 = np.uint32(0x80000000)
PAD = np.uint64(2**64 - 1)


def dist_bits(d):
    """Order-preserving uint32 bits of fp32 distances, -0.0 as +0.0."""
    u = np.asarray(d, np.float32).view(np.uint32).copy()
    u[u == NEG0] = 0
    return np.where(u & NEG0, ~u, u | NEG0).astype(np.uint64)


def id_bits(ids):
    return (np.asarray(ids, np.int32).view(np.uint32) ^ NEG0).astype(np.uint64)


def dist_major(ids, d):
    return (dist_bits(d) << np.uint64(32)) | id_bits(ids)


def id_major(ids, d):
    return (id_bits(ids) << np.uint64(32)) | dist_bits(d)


def swap(keys):
    return (keys << np.uint64(32)) | (keys >> np.uint64(32))


def masked(ids, d, n):
    bad = ids >= n
    return np.where(bad, n, ids).astype(np.int32), \
        np.where(bad, np.float32(BIG), d).astype(np.float32)


def sentinel(n):
    return dist_major(np.int32([n]), np.float32([BIG]))[0]


def threshold(cid, cd, n):
    """The rule: when one row's incumbents hold K distinct valid ids and
    the K-th smallest distance-major key is below the sentinel's, that key
    and the held ids' keys; else None (every proposal survives)."""
    ids, d = masked(cid, cd, n)
    held = {int(i): dist_major(np.int32([i]), np.float32([x]))[0]
            for i, x in zip(ids, d) if i < n}
    if len(held) < len(cid):
        return None
    theta = sorted(held.values())[len(cid) - 1]
    return (theta, held) if theta < sentinel(n) else None


def survivors(cid, cd, pid, pd_, n):
    """(B, P) mask of the proposals the kernel merges: below the threshold,
    and below the incumbent's key when the id is held."""
    keep = np.ones(pid.shape, bool)
    for r in range(len(cid)):
        rule = threshold(cid[r], cd[r], n)
        if rule is not None:
            theta, held = rule
            ids, d = masked(pid[r], pd_[r], n)
            keys = dist_major(ids, d)
            keep[r] = [k < theta and k < held.get(int(i), PAD)
                       for i, k in zip(ids, keys)]
    return keep


def _merge_list(keys, tags, n):
    """The kernel's merge(): id-major keys -> deduplicated, distance-major,
    ascending by (key, tag)."""
    order = np.lexsort((tags, keys))
    keys, tags = keys[order], tags[order]
    ids = keys >> np.uint64(32)
    dup = np.zeros(len(keys), bool)
    dup[1:] = ids[1:] == ids[:-1]
    dup |= ids >= id_bits(np.int32([n]))[0]
    keys = np.where(dup, sentinel(n), swap(keys))
    tags = np.where(dup, 0, tags).astype(np.uint64)
    order = np.lexsort((tags, keys))
    return keys[order], tags[order]


def _tags(pos, d):
    neg0 = np.asarray(d, np.float32).view(np.uint32) == NEG0
    return (np.asarray(pos, np.uint64) << np.uint64(1)) | neg0.astype(np.uint64)


def _insert(keys, tags, xkeys, xtags):
    """The kernel's insertion of a few survivors into sorted, distinct
    incumbents (all distance-major): a present id is replaced by a copy that
    comes before it, a new id enters at its rank and the last entry falls
    out."""
    keys, tags = list(keys), list(tags)
    K = len(keys)
    low = np.uint64(0xffffffff)
    for xk, xt in zip(xkeys, xtags):
        same = [r for r in range(K) if keys[r] & low == xk & low]
        if same:
            r = same[0]
            if not (xk, xt) < (keys[r], tags[r]):
                continue
            del keys[r], tags[r]
            keys.append(PAD)
            tags.append(np.uint64(2**32 - 1))
        rank = sum((k, t) < (xk, xt) for k, t in zip(keys, tags))
        if rank < K:
            keys.insert(rank, xk)
            tags.insert(rank, xt)
            del keys[K:], tags[K:]
    return np.array(keys, np.uint64), np.array(tags, np.uint64)


def kernel_model(cid, cd, pid, pd_, n):
    """The kernel's steps A-C in numpy, one row at a time (the incumbents'
    own merge stands for the kernel's check that they are already sorted,
    distinct and valid: the two agree on such rows)."""
    B, K = cid.shape
    P = pid.shape[1]
    out_i = np.empty((B, K), np.int32)
    out_d = np.empty((B, K), np.float32)
    for r in range(B):
        ids, d = masked(cid[r], cd[r], n)
        keys, tags = _merge_list(id_major(ids, d), _tags(np.arange(K), d), n)
        theta = keys[K - 1] if keys[K - 1] < sentinel(n) else PAD
        pi, pdd = masked(pid[r], pd_[r], n)
        pkeys = dist_major(pi, pdd)
        keep = pkeys < theta
        distinct = len(set(ids.tolist())) == K and (ids < n).all()
        if distinct and theta != PAD and K <= 128:   # the held-id table
            held = dict(zip(ids.tolist(), dist_major(ids, d)))
            keep &= np.array([k < held.get(int(i), PAD)
                              for i, k in zip(pi, pkeys)], bool)
        dk = dist_major(ids, d)
        sorted_ = distinct and bool((dk[1:] > dk[:-1]).all())
        if sorted_ and theta != PAD and K <= 128 and keep.sum() <= 32:
            keys, tags = _insert(keys[:K], tags[:K], pkeys[keep],
                                 _tags(K + np.arange(P), pdd)[keep])
        elif keep.any():
            keys, tags = _merge_list(
                np.concatenate([swap(keys[:K]), id_major(pi, pdd)[keep]]),
                np.concatenate([tags[:K],
                                _tags(K + np.arange(P), pdd)[keep]]), n)
        top = keys[:K]
        out_i[r] = (top & np.uint64(0xffffffff)).astype(np.uint32) ^ NEG0
        hi = (top >> np.uint64(32)).astype(np.uint32)
        bits = np.where(hi & NEG0, hi & np.uint32(0x7fffffff), ~hi)
        bits = np.where(tags[:K] & np.uint64(1), NEG0, bits).astype(np.uint32)
        out_d[r] = bits.view(np.float32)
    return out_i, out_d


def _rows(case, seed, B=40, K=16, P=120, n=300):
    rng = np.random.default_rng(seed)
    levels = np.float32([-1.0, -0.0, 0.0, 0.25, 1.0, 2.0, BIG])
    if case == "nn_descent":
        # sorted distinct incumbents; proposals mostly worse, some repeats
        # of incumbents, some ties with the K-th
        cid = np.stack([rng.choice(n, K, replace=False) for _ in range(B)])
        cd = np.sort(rng.uniform(0, 1, (B, K)).astype(np.float32), 1)
        cid = cid.astype(np.int32)
        pid = rng.integers(0, n + 2, (B, P)).astype(np.int32)
        pd_ = rng.uniform(0.5, 3, (B, P)).astype(np.float32)
        pid[:, :3], pd_[:, :3] = cid[:, -3:], cd[:, -3:]
        pid[:, 3:6], pd_[:, 3:6] = cid[:, :3], cd[:, :3] * 0.5
        pd_[:, 6:9] = cd[:, -1:]
        pid[:, 9:12] = pid[:, 12:15]
    elif case in ("ties", "few_ties"):
        # few distance levels, -0.0 beside +0.0 and negatives, sorted
        # distinct incumbents (the filter applies) with zero twins; with
        # few proposals the survivors are inserted one by one
        P = 24 if case == "few_ties" else P
        cid = np.stack([rng.choice(n, K, replace=False) for _ in range(B)])
        cd = levels[rng.integers(0, 6, (B, K))]
        order = np.lexsort((cid, cd + 0.0), axis=1)
        cid = np.take_along_axis(cid, order, 1).astype(np.int32)
        cd = np.take_along_axis(cd, order, 1)
        pid = rng.integers(-2, n + 2, (B, P)).astype(np.int32)
        pd_ = levels[rng.integers(0, 7, (B, P))]
        pid[:, :4], pd_[:, :4] = cid[:, :4], -cd[:, :4]
        pid[:, 4:8], pd_[:, 4:8] = cid[:, -4:], cd[:, -4:]
    elif case == "unsorted_repeats":
        cid = rng.integers(-1, n + 2, (B, K)).astype(np.int32)
        cd = rng.choice(levels, (B, K))
        pid = rng.integers(0, n + 2, (B, P)).astype(np.int32)
        pd_ = rng.choice(levels, (B, P))
        pid[:, :4] = cid[:, :4]
    elif case == "sentinel_incumbents":
        cid = np.full((B, K), n, np.int32)
        cd = np.full((B, K), BIG, np.float32)
        pid = rng.integers(0, n + 2, (B, P)).astype(np.int32)
        pd_ = rng.choice(levels, (B, P))
    elif case == "infinite":
        # incumbent distances past BIG: the K-th key is above the sentinel,
        # so no threshold, and sentinels rank before them
        cid = np.stack([rng.choice(n, K, replace=False) for _ in range(B)])
        cid = cid.astype(np.int32)
        cd = rng.uniform(0, 1, (B, K)).astype(np.float32)
        cd[:, K // 2:] = np.inf
        P = 3
        pid = rng.integers(0, n + 4, (B, P)).astype(np.int32)
        pd_ = rng.choice(np.float32([0.5, np.inf, 3.3e38]), (B, P))
    elif case == "no_proposals":
        cid = rng.integers(0, n + 2, (B, K)).astype(np.int32)
        cd = rng.choice(levels, (B, K))
        pid = np.zeros((B, 0), np.int32)
        pd_ = np.zeros((B, 0), np.float32)
    return cid, cd.astype(np.float32), pid, pd_.astype(np.float32), n


CASES = ["nn_descent", "ties", "few_ties", "unsorted_repeats",
         "sentinel_incumbents", "infinite", "no_proposals"]


def _ref(cid, cd, pid, pd_, n):
    i, d = candidate_merge_ref(*(torch.from_numpy(a) for a in
                                 (cid, cd, pid, pd_)), n)
    return i.numpy(), d.numpy()


def _assert_bits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  want[1].view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", CASES)
def test_merging_the_survivors_is_the_full_merge(case, seed):
    """The threshold rule drops only proposals that cannot enter the top K:
    the survivors, in their order and padded with sentinels, merge to the
    full merge's ids and distance bits."""
    cid, cd, pid, pd_, n = _rows(case, seed)
    keep = survivors(cid, cd, pid, pd_, n)
    width = int(keep.sum(1).max()) if keep.size else 0
    sid = np.full((len(cid), width), n, np.int32)
    sd = np.full((len(cid), width), BIG, np.float32)
    for r in range(len(cid)):
        k = int(keep[r].sum())
        sid[r, :k], sd[r, :k] = pid[r][keep[r]], pd_[r][keep[r]]
    _assert_bits(_ref(cid, cd, sid, sd, n), _ref(cid, cd, pid, pd_, n))
    if case == "nn_descent":      # the rule does cut the work on such rows
        assert keep.mean() < 0.5
    if case in ("sentinel_incumbents", "infinite", "no_proposals"):
        assert keep.all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", CASES)
def test_kernel_model_is_the_plain_merge(case, seed):
    """The kernel's steps (keys, tags, the two sorts, the threshold) in
    numpy give the plain merge's ids and distance bits."""
    cid, cd, pid, pd_, n = _rows(case, seed)
    _assert_bits(kernel_model(cid, cd, pid, pd_, n), _ref(cid, cd, pid, pd_, n))


def test_keys_order_as_the_plain_sort():
    """Distance keys order as floats (-0.0 == +0.0, negatives, inf) and id
    keys as signed ints."""
    d = np.float32([-np.inf, -3.0, -0.0, 0.0, 1e-30, 1.0, BIG, np.inf])
    b = dist_bits(d)
    assert (np.diff(b.astype(np.float64)) >= 0).all() and b[2] == b[3]
    assert (np.diff(b[[0, 1, 3, 4, 5, 6, 7]].astype(np.float64)) > 0).all()
    ids = np.int32([-2**31, -1, 0, 1, 2**31 - 1])
    assert (np.diff(id_bits(ids).astype(np.float64)) > 0).all()
