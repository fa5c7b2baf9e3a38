"""The stage-① round body of K1 and K2 (``csrc/traversal.cu``), written in
numpy, against the plain version.

The CUDA kernels run only on the card.  This file holds the steps of their
round body on the CPU, exactly as the kernel takes them, against
``kernels/ref.traversal_hop_ref`` (K2) and ``pilot_search_ref`` (K1):

* the visited filter packed from its (B, bits) bool rows with 16-byte
  chunks and a scalar head and tail where a row does not start on a
  16-byte boundary, and unpacked the same way;
* the frontier taken by ballots over 32 beam slots at a time (the first W
  unchecked live slots, and the last of them, whose slot marks the
  frontier as checked in the merge);
* per frontier, every id tested against the filter as it stood before,
  then the fresh ones inserted and compacted in candidate order;
* distances in ``lane_dot``'s order;
* the merge by rank over the compacted fresh candidates, ties included.

Ids, distance bits, checked flags, visited bits, fresh masks and counters
must be equal, on the reference's ``built_index`` (W 1-4, bloom and
exact; its vectors as built and snapped to a coarse grid, which makes
distances tie) and on a random graph of R 48 (more ids than a warp's
lanes).  The kernels themselves are held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.core import bloom as TB
from repro_torch.core import traversal as TT
from repro_torch.kernels.ref import pilot_search_ref, traversal_hop_ref

torch.set_num_threads(1)

U32 = np.uint32
BLOOM_BITS = 2048


# ---------------------------------------------------------------------------
# the visited filter in and out
# ---------------------------------------------------------------------------

def nonzero_bits4(x):
    """Bit i set for each non-zero byte i of the uint32 words x."""
    x = np.asarray(x, U32)
    m = (((x & U32(0x7f7f7f7f)) + U32(0x7f7f7f7f)) | x) & U32(0x80808080)
    return (((m >> U32(7)) * U32(0x00204081)) >> U32(21)) & U32(0xf)


def bytes_of_bits4(nib):
    return (np.asarray(nib, U32) * U32(0x00204081)) & U32(0x01010101)


def split_row(mis: int, length: int):
    head = min(length, (16 - mis) & 15)
    return head, (length - head) >> 4


def pack_row(row: np.ndarray, mis: int) -> np.ndarray:
    """``pack_filter``: the uint8 row, starting ``mis`` bytes past a
    16-byte boundary, as 32-bit words (plus the kernel's spare word)."""
    bits = len(row)
    words = np.zeros((bits + 31) // 32 + 1, np.uint64)
    head, chunks = split_row(mis, bits)
    tail = head + 16 * chunks
    body = np.ascontiguousarray(row[head:tail]).view("<u4").reshape(-1, 4)
    b16 = np.zeros(chunks, np.uint64)
    for i in range(4):
        b16 |= nonzero_bits4(body[:, i]).astype(np.uint64) << np.uint64(4 * i)
    o = head + 16 * np.arange(chunks)
    w, s = o >> 5, (o & 31).astype(np.uint64)
    np.bitwise_or.at(words, w, (b16 << s) & np.uint64(0xffffffff))
    spill = s > 16
    np.bitwise_or.at(words, w[spill] + 1, b16[spill] >> (np.uint64(32) - s[spill]))
    for at in [*range(head), *range(tail, bits)]:
        if row[at]:
            words[at >> 5] |= np.uint64(1 << (at & 31))
    return words.astype(U32)


def unpack_row(words: np.ndarray, bits: int, mis: int) -> np.ndarray:
    """``unpack_filter``: 16 bits at a time from any bit offset, four
    spread to four 0/1 bytes; the head and tail one by one."""
    head, chunks = split_row(mis, bits)
    tail = head + 16 * chunks
    out = np.zeros(bits, np.uint8)
    w64 = words.astype(np.uint64)
    o = head + 16 * np.arange(chunks)
    two = (w64[(o >> 5) + 1] << np.uint64(32)) | w64[o >> 5]
    b16 = ((two >> (o & 31).astype(np.uint64)) & np.uint64(0xffff)).astype(U32)
    body = np.stack([bytes_of_bits4((b16 >> U32(4 * i)) & U32(0xf))
                     for i in range(4)], 1)
    out[head:tail] = body.astype("<u4").view(np.uint8).reshape(-1)
    for at in [*range(head), *range(tail, bits)]:
        out[at] = (words[at >> 5] >> U32(at & 31)) & U32(1)
    return out


def test_bit_tricks_cover_every_byte_value():
    """Every byte value in every position: non-zero reads as set, and the
    spread writes 0/1 bytes."""
    v = np.arange(256, dtype=U32)
    for pos in range(4):
        got = (nonzero_bits4(v << U32(8 * pos)) >> U32(pos)) & U32(1)
        np.testing.assert_array_equal(got, (v != 0).astype(U32))
    nib = np.arange(16, dtype=U32)
    spread = bytes_of_bits4(nib).astype("<u4").view(np.uint8).reshape(16, 4)
    np.testing.assert_array_equal(spread, (nib[:, None] >> np.arange(4)) & 1)


@pytest.mark.parametrize("bits", [1, 15, 16, 17, 33, 602, 1051, 2048])
def test_filter_packs_and_unpacks_at_every_alignment(bits):
    """Rows of any length at each of the 16 offsets from a 16-byte
    boundary (exact filters have n + 1 bits, so row b starts at b·(n+1)):
    the words hold bit i iff byte i is non-zero, and the row comes back as
    its 0/1 bytes."""
    rng = np.random.default_rng(bits)
    for mis in range(16):
        row = np.where(rng.random(bits) < 0.3,
                       rng.integers(1, 256, bits), 0).astype(np.uint8)
        words = pack_row(row, mis)
        want = np.zeros(len(words) * 32, np.uint8)
        want[:bits] = row != 0
        np.testing.assert_array_equal(
            np.unpackbits(words.view(np.uint8), bitorder="little"), want)
        np.testing.assert_array_equal(unpack_row(words, bits, mis),
                                      (row != 0).astype(np.uint8))


# ---------------------------------------------------------------------------
# the round body
# ---------------------------------------------------------------------------

def bloom_hashes(x: int, bits: int):
    x = U32(x)
    with np.errstate(over="ignore"):
        a = (x * U32(0x9E3779B1)) ^ ((x * U32(0x85EBCA77)) >> U32(15))
        b = (x * U32(0xC2B2AE3D)) ^ (x >> U32(13)) ^ (x * U32(0x27D4EB2F))
    return int(a) % bits, int(b) % bits


def bit_is_set(words, bit):
    return (int(words[bit >> 5]) >> (bit & 31)) & 1


def set_bit(words, bit):
    words[bit >> 5] |= U32(1 << (bit & 31))


def lane_sums(x, y):
    """(M, d) x (M, d) -> (M,): lane l sums k = l, l+32, ... from 0 with
    separately rounded products and adds, then the xor butterfly."""
    M, d = x.shape
    acc = np.zeros((M, 32), np.float32)
    for k in range(d):
        acc[:, k % 32] = acc[:, k % 32] + x[:, k] * y[:, k]
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, np.arange(32) ^ o]
    return acc[:, 0]


def ballot(pred) -> int:
    return sum(1 << lane for lane, p in enumerate(pred) if p)


def popc(m: int) -> int:
    return bin(m).count("1")


def round_model(q, nbr, vec, st, n, W, exact, bits):
    """One round of one block.  ``st`` holds the beam (ids, d, ck lists),
    the filter words and the counters; returns the fresh mask (W·R) or None
    when the beam has no work (the kernel's exit)."""
    ids, d, ck, words = st["ids"], st["d"], st["ck"], st["words"]
    ef, R = len(ids), nbr.shape[1]
    # 1. the frontier, 32 slots a ballot
    found, s_last, fu = 0, -1, [n] * W
    for base in range(0, ef, 32):
        if found >= W:
            break
        lanes = range(base, min(base + 32, ef))
        un = [not ck[i] and ids[i] < n for i in lanes]
        m = ballot(un)
        rank = [found + popc(m & ((1 << lane) - 1)) for lane in range(len(un))]
        for lane, i in enumerate(lanes):
            if un[lane] and rank[lane] < W:
                fu[rank[lane]] = ids[i]
        took = min(W - found, popc(m))
        last = ballot([u and r == found + took - 1 for u, r in zip(un, rank)])
        if took:
            s_last = base + (last & -last).bit_length() - 1
        found += took
    if found == 0:
        return None
    # 2. the W·R ids; per frontier test every id, then insert and compact
    cid = nbr[np.array(fu)].reshape(-1).astype(np.int64)
    cfr = np.zeros(W * R, bool)
    fid = []
    for w in range(W):
        for j in range(R):
            v = cid[w * R + j]
            key = int(v) if v < n else 0
            if exact:
                seen = bit_is_set(words, key)
            else:
                h1, h2 = bloom_hashes(key, bits)
                seen = bit_is_set(words, h1) and bit_is_set(words, h2)
            cfr[w * R + j] = v < n and not seen
        for j in range(R):
            if cfr[w * R + j]:
                key = int(cid[w * R + j])
                if exact:
                    set_bit(words, key)
                else:
                    for h in bloom_hashes(key, bits):
                        set_bit(words, h)
                fid.append(key)
    # 3. distances in lane order
    nf = len(fid)
    if nf:
        rows = vec[np.array(fid)]
        qq = np.broadcast_to(q, rows.shape)
        qn = lane_sums(q[None], q[None])[0]
        fd = np.maximum((qn + lane_sums(rows, rows))
                        - np.float32(2.0) * lane_sums(rows, qq), np.float32(0))
    else:
        fd = np.zeros(0, np.float32)
    # 4. the merge by rank
    nid, nd, nck = [None] * ef, [None] * ef, [None] * ef
    for i in range(ef):
        pos = i + int((fd < d[i]).sum())
        if pos < ef:
            nid[pos], nd[pos] = ids[i], d[i]
            nck[pos] = ck[i] or (i <= s_last and ids[i] < n)
    for j in range(nf):
        pos = int(np.searchsorted(np.array(d, np.float32), fd[j], "right"))
        pos += int(((fd < fd[j]) | ((fd == fd[j]) & (np.arange(nf) < j))).sum())
        if pos < ef:
            nid[pos], nd[pos], nck[pos] = fid[j], fd[j], False
    st.update(ids=nid, d=nd, ck=nck, n_dist=st["n_dist"] + nf,
              n_hops=st["n_hops"] + 1, n_exp=st["n_exp"] + found)
    return cfr


def model(q, nbr, vec, bid, bd, bck, vis, n, *, W, mode, rounds):
    """The kernel on every query: pack, ``rounds`` rounds (or until the
    beam has no work), unpack.  Returns the hop kernel's outputs and the
    counters."""
    B, bits = vis.shape
    exact = mode == "exact"
    out = {k: [] for k in ("ids", "d", "ck", "vis", "fresh", "n_dist",
                           "n_hops", "n_exp")}
    flat = np.ascontiguousarray(vis.astype(np.uint8)).reshape(-1)
    for b in range(B):
        mis = (b * bits) % 16             # the tensor's base is aligned
        st = dict(ids=list(bid[b]), d=list(bd[b]), ck=list(bck[b]),
                  words=pack_row(flat[b * bits:(b + 1) * bits], mis),
                  n_dist=0, n_hops=0, n_exp=0)
        fresh = np.zeros(W * nbr.shape[1], bool)
        for _ in range(rounds):
            cfr = round_model(q[b], nbr, vec, st, n, W, exact, bits)
            if cfr is None:
                break
            fresh = cfr
        out["ids"].append(st["ids"])
        out["d"].append(st["d"])
        out["ck"].append(st["ck"])
        out["vis"].append(unpack_row(st["words"], bits, mis).astype(bool))
        out["fresh"].append(fresh)
        for k in ("n_dist", "n_hops", "n_exp"):
            out[k].append(st[k])
    return {k: np.array(v) for k, v in out.items()}


def _assert_equal(got: dict, want, names):
    for name, w in zip(names, want):
        w = w.numpy()
        g = got[name].astype(w.dtype)
        if w.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)


def _start_state(q, nbr, vec, n, mode, seed, B, ef=32):
    """``init_state`` from seeded entry points, three plain rounds in (so
    the beam holds checked and unchecked entries)."""
    rng = np.random.default_rng(seed)
    entry = torch.from_numpy(rng.integers(0, n, (B, 8)).astype(np.int32))
    spec = TT.TraversalSpec(ef=ef, visited_mode=mode, bloom_bits=BLOOM_BITS)
    qt, nt, vt = (torch.from_numpy(a) for a in (q, nbr, vec))
    st = TT.init_state(spec, qt, entry, vt, n)
    for _ in range(3):
        st = TT.expansion_round(spec, st, qt, nt, vt, n)
    return [qt, nt, vt, st.cand_id, st.cand_d, st.checked, st.visited]


def _index_inputs(built_index, snap: bool, B=12):
    nbr = np.array(built_index.arrays["sub_neighbors"])
    vec = np.array(built_index.arrays["primary"], np.float32)
    n = nbr.shape[0] - 1
    assert vec.shape[0] == n + 1
    q = np.random.default_rng(1).normal(size=(B, vec.shape[1])).astype(np.float32)
    if snap:         # a coarse grid: many distances tie exactly
        vec, q = np.round(vec * 2) / 2, np.round(q * 2) / 2
    return q.astype(np.float32), nbr, vec.astype(np.float32), n


def _random_graph(n=500, R=48, d=24, seed=5):
    rng = np.random.default_rng(seed)
    nbr = np.stack([rng.choice(n, R, replace=False) for _ in range(n)])
    nbr = np.concatenate([nbr, np.full((1, R), n)]).astype(np.int32)
    vec = np.concatenate([rng.normal(size=(n, d)),
                          np.zeros((1, d))]).astype(np.float32)
    q = rng.normal(size=(10, d)).astype(np.float32)
    return q, nbr, vec, n


def _hold(inputs, n, W, mode):
    """K2 (one round) and K1 (to convergence) of the model against the
    plain versions; returns the plain K1 outputs."""
    arrs = [a.numpy() for a in inputs]
    want = traversal_hop_ref(*inputs, n, width=W, visited_mode=mode)
    got = model(*arrs, n, W=W, mode=mode, rounds=1)
    _assert_equal(got, want, ("ids", "d", "ck", "vis", "fresh"))
    want = pilot_search_ref(*inputs, n, rounds=256, width=W, visited_mode=mode)
    got = model(*arrs, n, W=W, mode=mode, rounds=256)
    _assert_equal(got, want, ("ids", "d", "ck", "vis", "n_dist", "n_hops",
                              "n_exp"))
    assert int(want[5].max()) > 1
    return want


@pytest.mark.parametrize("mode", ["bloom", "exact"])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_round_model_on_the_built_index(built_index, W, mode):
    q, nbr, vec, n = _index_inputs(built_index, snap=False)
    _hold(_start_state(q, nbr, vec, n, mode, seed=W, B=len(q)), n, W, mode)


@pytest.mark.parametrize("mode", ["bloom", "exact"])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_round_model_with_tied_distances(built_index, W, mode):
    """Vectors and queries on a grid of 0.5: the merge's ties (beam before
    fresh, fresh in candidate order) decide the beam."""
    q, nbr, vec, n = _index_inputs(built_index, snap=True)
    inputs = _start_state(q, nbr, vec, n, mode, seed=10 + W, B=len(q))
    d = _hold(inputs, n, W, mode)[1]
    fin = d[torch.isfinite(d)]
    assert len(torch.unique(fin)) < len(fin)       # ties did occur


@pytest.mark.parametrize("mode", ["bloom", "exact"])
def test_round_model_wider_than_a_warp(mode):
    """R 48: a frontier's ids take two passes of the warp's lanes."""
    q, nbr, vec, n = _random_graph()
    _hold(_start_state(q, nbr, vec, n, mode, seed=3, B=len(q)), n, 2, mode)


def test_bloom_hashes_match_the_port():
    ids = np.array([0, 1, 7, 4095, 65535, 2**31 - 1], np.int64)
    h1, h2 = TB.hashes(torch.from_numpy(ids), BLOOM_BITS)
    assert [bloom_hashes(int(x), BLOOM_BITS) for x in ids] == list(
        zip(h1.tolist(), h2.tolist()))
