"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test carries the ``cuda`` marker and skips without a CUDA
device.  This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bloom as TB
from repro_torch.core import device_build as TDB
from repro_torch.core import graph_build as TGB
from repro_torch.core import quant as TQ
from repro_torch.core.multistage import bucket_size
from repro_torch.kernels import (build_kernel, fes_kernel, launch_counts, ops,
                                 ref as TR, topk_kernel, traversal_kernel)
from repro_torch.kernels import flash_attention as k8
from repro_torch.kernels.flash_attention import TENSOR_CORE_HEAD_DIMS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _hop_inputs(B_, R, ef, d, mode, seed, n=600, id_dtype=np.int16,
                distinct=True):
    """Random regular digraph (rows of distinct ids unless ``distinct`` is
    false), random vectors, a sorted random beam with sentinels, and the
    beam inserted into the visited filter."""
    rng = np.random.default_rng(seed)
    nbr = (np.stack([rng.choice(n, R, replace=False) for _ in range(n)])
           if distinct else rng.integers(0, n, (n, R)))
    nbr_t = np.concatenate([nbr, np.full((1, R), n)]).astype(id_dtype)
    x = rng.normal(size=(n, d)).astype(np.float32)
    vec_t = np.concatenate([x, np.zeros((1, d), np.float32)])
    q = rng.normal(size=(B_, d)).astype(np.float32)
    bid = rng.integers(0, n, (B_, ef)).astype(np.int32)
    bd = np.sort(rng.random((B_, ef)).astype(np.float32) * 40, axis=1)
    bck = rng.random((B_, ef)) > 0.6
    bid[:, -3:], bd[:, -3:], bck[:, -3:] = n, np.inf, True
    live = torch.from_numpy(bid < n)
    key = torch.from_numpy(np.where(bid < n, bid, 0))
    vis = (TB.bloom_insert(TB.bloom_init(B_, 2048), key, live) if mode == "bloom"
           else TB.exact_insert(TB.exact_init(B_, n), key, live))
    arrs = [torch.from_numpy(a) for a in (q, nbr_t, vec_t, bid, bd, bck)]
    return arrs + [vis], n


@pytest.mark.cuda
@pytest.mark.parametrize("mode,W,id_dtype", [("bloom", 1, np.int16),
                                             ("bloom", 4, np.int32),
                                             ("exact", 2, np.int16)])
def test_traversal_kernels_match_plain(cuda, mode, W, id_dtype):
    """Bit-equal: the kernel sums distances in the plain version's order."""
    arrs, n = _hop_inputs(33, 16, 32, 48, mode, seed=W, id_dtype=id_dtype)
    t = [a.to(cuda) for a in arrs]
    before = launch_counts()["fused_traversal_hop"]
    got = traversal_kernel.fused_traversal_hop(*t, n, width=W, visited_mode=mode)
    want = TR.traversal_hop_ref(*t, n, width=W, visited_mode=mode)
    assert launch_counts()["fused_traversal_hop"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = traversal_kernel.fused_pilot_search(*t, n, rounds=128, width=W,
                                              visited_mode=mode)
    want = TR.pilot_search_ref(*t, n, rounds=128, width=W, visited_mode=mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B_,R,ef,n,mode,W", [
    (20, 16, 32, 601, "exact", 1),   # odd n: filter rows of n + 1 = 602
    (20, 16, 32, 599, "exact", 3),   # bytes start off 16-byte boundaries
    (264, 16, 32, 600, "bloom", 1),  # more queries than the card's 132 SMs
    (24, 48, 64, 600, "bloom", 2),   # R 48: more ids than a warp's lanes
    (24, 48, 64, 601, "exact", 4),
])
def test_traversal_kernels_edge_shapes_bit_equal(cuda, B_, R, ef, n, mode, W):
    """K2 and K1 bit-equal to the plain version where the round body's
    layout has edges: unaligned exact filter rows (packed and unpacked
    with a scalar head and tail around 16-byte accesses), a grid larger
    than the card, and frontiers of more than 32 ids."""
    arrs, n = _hop_inputs(B_, R, ef, 48, mode, seed=B_ + R + n, n=n,
                          id_dtype=np.int32)
    t = [a.to(cuda) for a in arrs]
    got = traversal_kernel.fused_traversal_hop(*t, n, width=W, visited_mode=mode)
    want = TR.traversal_hop_ref(*t, n, width=W, visited_mode=mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = traversal_kernel.fused_pilot_search(*t, n, rounds=128, width=W,
                                              visited_mode=mode)
    want = TR.pilot_search_ref(*t, n, rounds=128, width=W, visited_mode=mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[5].max()) > 1                  # several rounds ran


@pytest.mark.cuda
@pytest.mark.parametrize("R,n,mode,W,tiled", [
    (32, 3_000, "bloom", 1, True),       # 32 rows of 1,536 B in the tile
    (32, 3_000, "bloom", 4, True),       # 128 rows: 192 KB of tile
    (32, 250_000, "exact", 4, False),    # + a 31 KB exact filter: too much
    (48, 3_000, "bloom", 4, False),      # 192 rows: over the limit alone
])
def test_traversal_kernels_wide_rows_bit_equal(cuda, R, n, mode, W, tiled):
    """K2 and K1 at the pilot width of the 768-d presets (dp 384, fp32):
    the round's rows go through the shared-memory tile where it fits, and
    are read from device memory where it does not; both bit-equal."""
    dp, ef = 384, 128
    arrs, n = _hop_inputs(16, R, ef, dp, mode, seed=R + n + W, n=n,
                          id_dtype=np.int32, distinct=False)
    t = [a.to(cuda) for a in arrs]
    smem = traversal_kernel._lib().pilot_traversal_smem_bytes(
        dp, ef, W, R, t[6].shape[1], 0, 0, 0, dp)
    assert (smem > W * R * 4 * dp) == tiled
    got = traversal_kernel.fused_traversal_hop(*t, n, width=W, visited_mode=mode)
    want = TR.traversal_hop_ref(*t, n, width=W, visited_mode=mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = traversal_kernel.fused_pilot_search(*t, n, rounds=128, width=W,
                                              visited_mode=mode)
    want = TR.pilot_search_ref(*t, n, rounds=128, width=W, visited_mode=mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[5].max()) > 1                  # several rounds ran


@pytest.mark.cuda
@pytest.mark.parametrize("tomb", [False, True])
@pytest.mark.parametrize("mode", ["bloom", "exact"])
@pytest.mark.parametrize("B_", [8, 128])
@pytest.mark.parametrize("d", [96, 200])
def test_final_traversal_kernel_bit_equal(cuda, d, B_, mode, tomb):
    """Stage ③'s kernel (``fused_final_search``) at the benchmark's widths,
    R 32, ef 128, an int32 table, against its plain version: ids, distance
    bits, flags, filter and counters equal, with and without a deletion
    bitmap; counted under its own name, never under K1's."""
    n = 20_000
    arrs, n = _hop_inputs(B_, 32, 128, d, mode, seed=d + B_, n=n,
                          id_dtype=np.int32, distinct=False)
    t = [a.to(cuda) for a in arrs]
    t[4] = t[4] * (d / 10)               # beam distances near the rows'
    if mode == "bloom":                  # stage ③'s filter width
        live = t[3] < n
        t[6] = TB.bloom_insert(TB.bloom_init(B_, 16384, device=cuda),
                               t[3].masked_fill(~live, 0), live)
    kw = dict(rounds=512, visited_mode=mode)
    if tomb:
        dead = torch.zeros(n + 1, dtype=torch.bool, device=cuda)
        dead[torch.randperm(n, device=cuda)[:n // 20]] = True
        kw["tombstone"] = dead
    before = launch_counts()
    got = traversal_kernel.fused_final_search(*t, n, **kw)
    after = launch_counts()
    want = TR.pilot_search_ref(*t, n, **kw)
    assert after["fused_final_search"] == before["fused_final_search"] + 1
    assert after["fused_pilot_search"] == before["fused_pilot_search"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[5].max()) > 8                  # many rounds ran


@pytest.mark.cuda
def test_host_layout_equals_the_kernels(cuda):
    """``traversal_kernel.smem_bytes`` (the host's layout, which the
    dispatch judges without the card) equals the library's
    ``pilot_traversal_smem_bytes`` over every encoding and the tile's
    edges, and the limits agree."""
    lib = traversal_kernel._lib()
    assert lib.pilot_traversal_smem_limit() == traversal_kernel.SMEM_LIMIT
    for dq, ef, W, R, vbits, scaled, lut, enc, vw in [
            (96, 128, 1, 32, 16384, 0, 0, 0, 96),      # stage ③, deep1m
            (200, 128, 1, 32, 16384, 0, 0, 0, 200),    # stage ③, syn200
            (384, 128, 4, 32, 16384, 0, 0, 0, 384),    # tile 192 KB
            (384, 128, 4, 48, 16384, 0, 0, 0, 384),    # no tile
            (48, 128, 1, 32, 1_000_001, 0, 0, 0, 48),  # exact, 1M
            (96, 128, 1, 32, 2_000_001, 0, 0, 0, 96),  # over the limit
            (48, 64, 2, 16, 2048, 0, 0, 1, 48),        # bf16
            (48, 64, 2, 16, 2048, 1, 0, 2, 48),        # int8 + scale
            (48, 64, 3, 16, 2049, 1, 0, 3, 24),        # int4
            (48, 64, 1, 16, 2048, 0, 4096, 4, 16)]:    # pq
        row_bytes = {0: 4 * vw, 1: 2 * vw}.get(enc, vw)
        assert traversal_kernel.smem_bytes(
            dq, ef, W, R, vbits, bool(scaled), lut, row_bytes) == \
            lib.pilot_traversal_smem_bytes(dq, ef, W, R, vbits, scaled, lut,
                                           enc, vw)


@pytest.mark.cuda
def test_traversal_kernel_refuses_what_it_cannot_hold(cuda):
    arrs, n = _hop_inputs(4, 8, 16, 16, "bloom", seed=0)
    t = [a.to(cuda) for a in arrs]
    big = torch.zeros((4, 3_000_000), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        traversal_kernel.fused_traversal_hop(*t[:6], big, n)
    with pytest.raises(TypeError, match="float32|bfloat16|int8"):
        traversal_kernel.fused_traversal_hop(
            t[0], t[1], t[2].to(torch.float16), *t[3:], n)


def _encode(x, dtype):
    """(table, vec_scale, vec_codebook) as CPU tensors."""
    data, side = TQ.quantize(x, dtype)
    data = data if isinstance(data, torch.Tensor) else torch.from_numpy(data)
    side = None if side is None else torch.from_numpy(side)
    return (data, None, side) if dtype == "pq" else (data, side, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4", "pq"])
@pytest.mark.parametrize("id_dtype", [np.int16, np.int32])
def test_traversal_kernels_every_encoding_bit_equal(cuda, dtype, id_dtype):
    """K2 (W 1 and 3) and K1 on bf16, int8, int4 and pq tables: ids, flags,
    visited bits, fresh masks, counters and distance bits equal to the
    plain version.  The int4 table holds codes -7 and 7 in both nibble
    planes, d odd (one pad nibble)."""
    arrs, n = _hop_inputs(29, 16, 32, 47, "bloom", seed=3, id_dtype=id_dtype)
    vec, scale, cb = _encode(arrs[2].numpy(), dtype)
    if dtype == "int4":
        codes = TQ.int4_unpack(vec)
        for plane in (codes[:, :vec.shape[1]], codes[:, vec.shape[1]:47]):
            assert (plane == -7).any() and (plane == 7).any()
    t = [a.to(cuda) for a in arrs[:2]] + [vec.to(cuda)] + [
        a.to(cuda) for a in arrs[3:]]
    side = dict(vec_scale=None if scale is None else scale.to(cuda),
                vec_codebook=None if cb is None else cb.to(cuda))
    for W in (1, 3):
        before = launch_counts()["fused_traversal_hop"]
        got = traversal_kernel.fused_traversal_hop(*t, n, width=W, **side)
        want = TR.traversal_hop_ref(*t, n, width=W, **side)
        assert launch_counts()["fused_traversal_hop"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    before = launch_counts()["fused_pilot_search"]
    got = traversal_kernel.fused_pilot_search(*t, n, rounds=128, width=2, **side)
    want = TR.pilot_search_ref(*t, n, rounds=128, width=2, **side)
    assert launch_counts()["fused_pilot_search"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,counter", [
    ("bfloat16", "fes_distances"), ("int8", "fes_distances"),
    ("int4", "fes_int4_distances"), ("pq", "fes_pq_distances")])
def test_fes_kernels_every_encoding_match_plain(cuda, dtype, counter):
    """K3 with bf16/int8 entries, K4 (int4) and K5 (pq) against the plain
    version within 1e-4, ragged shapes, each launch counted on its own
    wrapper."""
    rng = np.random.default_rng(4)
    qg = torch.from_numpy(rng.normal(size=(5, 70, 47)).astype(np.float32))
    ev, scale, cb = _encode(rng.normal(size=(5, 130, 47)).astype(np.float32),
                            dtype)
    kw = dict(scale=scale, codebook=cb)
    want = TR.fes_distances_ref(qg, ev, **kw)
    wrapper = getattr(fes_kernel, counter)
    before = launch_counts()[wrapper.__name__]
    got = fes_kernel.fes_distances(
        qg.to(cuda), ev.to(cuda),
        **{k: None if v is None else v.to(cuda) for k, v in kw.items()})
    assert launch_counts()[wrapper.__name__] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * 47)


@pytest.mark.cuda
def test_fes_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    qg = torch.from_numpy(rng.normal(size=(5, 70, 48)).astype(np.float32)).to(cuda)
    ev = torch.from_numpy(rng.normal(size=(5, 130, 48)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(fes_kernel.fes_distances(qg, ev),
                               TR.fes_distances_ref(qg, ev),
                               rtol=1e-4, atol=1e-4 * 48)


@pytest.mark.cuda
def test_fes_select_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    r, C, d, L = 8, 200, 48, 16
    cent = rng.normal(size=(r, d)).astype(np.float32)
    ent = rng.normal(size=(r, C, d)).astype(np.float32)
    eid = rng.integers(0, 5000, (r, C)).astype(np.int32)
    val = rng.random((r, C)) > 0.1
    q = rng.normal(size=(77, d)).astype(np.float32)
    cpu = [torch.from_numpy(a) for a in (q, cent, ent, eid, val)]
    ids_c, d_c = ops.fes_select(*cpu, L=L)
    ids_g, d_g = ops.fes_select(*[a.to(cuda) for a in cpu], L=L)
    assert torch.equal(ids_g.cpu(), ids_c)
    torch.testing.assert_close(d_g.cpu(), d_c, rtol=1e-4, atol=1e-3)


def _topl_flips(got, want, L):
    """Rows of two (r, QC, C) blocks whose top-L entry sets differ, leaving
    out rows where ``want``'s L-th and (L+1)-th values are a near-tie."""
    r, QC, C = want.shape
    g, w = got.reshape(r * QC, C), want.reshape(r * QC, C)
    gi = torch.sort(torch.topk(g, L, largest=False).indices, 1).values
    wd, wi = torch.topk(w, L + 1, largest=False)
    wi = torch.sort(wi[:, :L], 1).values
    tie = (wd[:, L] - wd[:, L - 1]).abs() <= 1e-5 * wd[:, L].abs()
    return int(((gi != wi).any(1) & ~tie).sum())


def _grouped_batch(cuda, d, rows=None, seed=0, r=32, B=128):
    """The main path's layout: B queries routed to r random centroids and
    grouped with capacity B by ``ops.group_queries`` (r, B, d), so most
    slots are zero rows.  ``rows`` replaces the first queries."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, d)).astype(np.float32)
    for i, row in enumerate(rows or ()):
        q[i] = row
    cent = rng.normal(size=(r, d)).astype(np.float32)
    qg, _ = ops.group_queries(torch.from_numpy(q).to(cuda),
                              torch.from_numpy(cent).to(cuda), B)
    return qg


def _fes_check(qg, ev, scale, cb, counter, L=32):
    """The wrapper against the plain version on the card: within 1e-4,
    no top-L flips, one launch counted on ``counter``."""
    d = qg.shape[2]
    kw = dict(scale=scale, codebook=cb)
    wrapper = getattr(fes_kernel, counter)
    before = launch_counts()[wrapper.__name__]
    got = fes_kernel.fes_distances(qg, ev, **kw)
    want = TR.fes_distances_ref(qg, ev, **kw)
    torch.cuda.synchronize()
    assert launch_counts()[wrapper.__name__] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * d)
    assert _topl_flips(got, want, min(L, ev.shape[1] - 1)) == 0
    return got, want


FES_COUNTER = {"float32": "fes_distances", "bfloat16": "fes_distances",
               "int8": "fes_distances", "int4": "fes_int4_distances",
               "pq": "fes_pq_distances"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,C", [
    ("float32", 48, 512), ("bfloat16", 48, 512), ("int8", 48, 512),
    ("int4", 48, 512), ("pq", 48, 512),
    ("float32", 47, 130), ("int4", 47, 130), ("pq", 47, 130)])
def test_fes_kernels_on_the_main_path_layout(cuda, dtype, d, C):
    """K3-K5 on a grouped batch of 128 queries over 32 clusters (most slots
    zero rows), C 512 or 130 (not a multiple of 4: the 16-byte stores'
    scalar tail), d 48 or 47 (int4 rows with a pad nibble, no padding in
    the wrapper)."""
    qg = _grouped_batch(cuda, d)
    rng = np.random.default_rng(1)
    ev, scale, cb = _encode(rng.normal(size=(32, C, d)).astype(np.float32),
                            dtype)
    _fes_check(qg, ev.to(cuda), None if scale is None else scale.to(cuda),
               None if cb is None else cb.to(cuda), FES_COUNTER[dtype])
    assert float((qg == 0).all(-1).float().mean()) > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4",
                                   "pq"])
def test_fes_kernels_zero_and_tiny_queries(cuda, dtype):
    """A real query that is all zeros (its slot is a zero row), and one of
    values around 1e-30: its squared norm underflows to 0 but the row is
    not zero, so the kernels must do its products."""
    d, C = 47, 130
    tiny = np.full(d, 1e-30, np.float32)
    tiny[::2] = -1e-30
    qg = _grouped_batch(cuda, d, rows=[np.zeros(d, np.float32), tiny],
                        seed=2)
    rng = np.random.default_rng(3)
    ev, scale, cb = _encode(rng.normal(size=(32, C, d)).astype(np.float32),
                            dtype)
    _fes_check(qg, ev.to(cuda), None if scale is None else scale.to(cuda),
               None if cb is None else cb.to(cuda), FES_COUNTER[dtype])
    tiny_rows = (qg.abs() == 1e-30).all(-1)
    assert int(tiny_rows.sum()) == 1
    assert float(qg[tiny_rows].square().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 200), ("bfloat16", 130),
                                     ("int8", 97), ("int4", 301),
                                     ("pq", 200)])
def test_fes_kernels_wide_rows(cuda, dtype, d):
    """Rows wider than K3/K4 stage whole go through the kernel's ring of
    d-chunks (every slot does its products there); K5's codebook too wide
    to stage is read through the cache."""
    qg = _grouped_batch(cuda, d, r=8, B=64, seed=6)
    rng = np.random.default_rng(7)
    ev, scale, cb = _encode(rng.normal(size=(8, 130, d)).astype(np.float32),
                            dtype)
    _fes_check(qg, ev.to(cuda), None if scale is None else scale.to(cuda),
               None if cb is None else cb.to(cuda), FES_COUNTER[dtype])


@pytest.mark.cuda
def test_fes_int4_wrapper_launches_only_the_kernel(cuda):
    """At odd d the int4 wrapper hands the kernel the queries and the
    scale at their own width: no torch op runs on the card before K4."""
    from torch.profiler import ProfilerActivity, profile
    d = 47
    qg = _grouped_batch(cuda, d)
    rng = np.random.default_rng(4)
    ev, scale, _ = _encode(rng.normal(size=(32, 512, d)).astype(np.float32),
                           "int4")
    ev, scale = ev.to(cuda), scale.to(cuda)
    fes_kernel.fes_int4_distances(qg, ev, scale)                 # build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fes_kernel.fes_int4_distances(qg, ev, scale)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "fes_tile_kernel" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("m,ksub,d", [(8, 16, 48), (16, 160, 32)])
def test_fes_pq_kernel_table_widths(cuda, m, ksub, d):
    """K5 at the main path's m·ksub 128 and at 2,560 columns, whose tables
    come within a few KB of the 227 KB limit (the codebook, 328 KB, is
    read through the cache)."""
    smem, limit = fes_kernel._pq_smem(fes_kernel._lib(), m, ksub)
    assert smem <= limit and (m * ksub < 1000 or smem > 0.95 * limit)
    qg = _grouped_batch(cuda, d, r=8, B=64)
    rng = np.random.default_rng(5)
    # codes below 128: the plain version reads them as signed int8
    codes = torch.from_numpy(rng.integers(0, min(ksub, 128), (8, 300, m))
                             .astype(np.int8)).to(cuda)
    cb = torch.from_numpy(rng.normal(size=(d, m * ksub)).astype(
        np.float32)).to(cuda)
    _fes_check(qg, codes, None, cb, "fes_pq_distances")


@pytest.mark.cuda
def test_fes_pq_kernel_refuses_tables_over_the_limit(cuda):
    qg = torch.zeros((2, 16, 32), device=cuda)
    codes = torch.zeros((2, 64, 16), dtype=torch.int8, device=cuda)
    cb = torch.zeros((32, 16 * 256), device=cuda)
    before = launch_counts()["fes_pq_distances"]
    with pytest.raises(ValueError, match="too wide"):
        fes_kernel.fes_distances(qg, codes, codebook=cb)
    assert launch_counts()["fes_pq_distances"] == before


def _merge_inputs(seed, B, K, P, n, ties):
    """Lists with sentinels, ids past n, cross-list duplicates at other
    distances; with ``ties``, few distance levels including -0.0 beside
    +0.0 and BIG, and whole BIG rows."""
    rng = np.random.default_rng(seed)
    cid = rng.integers(0, n + 2, (B, K)).astype(np.int32)
    pid = rng.integers(0, n + 2, (B, P)).astype(np.int32)
    pid[:, :4] = cid[:, :4]
    if ties:
        levels = np.array([0.0, -0.0, 0.25, 1.0, 3.0e38], np.float32)
        cd = levels[rng.integers(0, 5, (B, K))]
        pd_ = levels[rng.integers(0, 5, (B, P))]
        cid[::7], cd[::7] = n, np.float32(3.0e38)
    else:
        cd = rng.uniform(0, 4, (B, K)).astype(np.float32)
        pd_ = rng.uniform(0, 4, (B, P)).astype(np.float32)
        pd_[:, :2] = cd[:, :2] + 0.5
        pd_[:, 2:4] = np.maximum(cd[:, 2:4] - 0.25, 0)
    return [torch.from_numpy(a) for a in (cid, cd, pid, pd_)]


def _assert_merge_bit_equal(t, n):
    before = launch_counts()["fused_candidate_merge"]
    gi, gd = build_kernel.fused_candidate_merge(*t, n)
    assert launch_counts()["fused_candidate_merge"] == before + 1
    wi, wd = TR.candidate_merge_ref(*t, n)
    assert torch.equal(gi, wi)
    assert torch.equal(gd.view(torch.int32), wd.view(torch.int32))
    return wi, wd


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,P,ties", [(12, 16, 24, False),
                                        (300, 64, 272, False),
                                        (300, 64, 272, True),
                                        (50, 8, 20, True)])
def test_candidate_merge_kernel_bit_equal(cuda, B, K, P, ties):
    n = 1000
    t = [a.to(cuda) for a in _merge_inputs(B + K, B, K, P, n, ties)]
    wi, wd = _assert_merge_bit_equal(t, n)
    # the card's plain version agrees with the CPU's
    ci, cd = TR.candidate_merge_ref(*(a.cpu() for a in t), n)
    assert torch.equal(wi.cpu(), ci)
    assert torch.equal(wd.cpu().view(torch.int32), cd.view(torch.int32))


def _filtered_inputs(seed, B, K, P, n):
    """Sorted, distinct, valid incumbents (so the kernel's threshold
    applies) with proposals that tie the threshold, repeat incumbents at
    equal, smaller and larger distances, carry -0.0 against +0.0 and
    negative distances, and repeat each other."""
    rng = np.random.default_rng(seed)
    cid = np.stack([rng.choice(n, K, replace=False) for _ in range(B)])
    cd = rng.choice(np.float32([-1.0, -0.0, 0.0, 0.5, 1.0, 2.0, 4.0]),
                    (B, K))
    order = np.lexsort((cid, cd + 0.0), axis=1)
    cid = np.take_along_axis(cid, order, 1).astype(np.int32)
    cd = np.take_along_axis(cd, order, 1).astype(np.float32)
    pid = rng.integers(0, n + 3, (B, P)).astype(np.int32)
    pd_ = rng.choice(np.float32([-2.0, -0.0, 0.0, 0.5, 1.0, 4.0, 8.0]),
                     (B, P))
    pid[:, :4], pd_[:, :4] = cid[:, -4:], cd[:, -4:]         # the threshold
    pid[:, 4:8], pd_[:, 4:8] = cid[:, :4], -cd[:, :4]        # zeros flipped
    pid[:, 8:12] = pid[:, 12:16]                             # repeats
    return [torch.from_numpy(a) for a in (cid, cd, pid, pd_.astype(np.float32))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["filtered", "sentinel_incumbents",
                                  "no_proposals", "one_proposal"])
def test_candidate_merge_kernel_adversarial_rows(cuda, case):
    """Bit-equal to the plain merge on both of the kernel's branches: the
    threshold filter (sorted distinct incumbents, ties and repeats at the
    threshold, -0.0 and negative distances) and the full merge (all
    sentinel incumbents, no or one proposal, unsorted repeats)."""
    n, B, K = 500, 200, 64
    if case == "filtered":
        t = _filtered_inputs(1, B, K, 784, n)
    elif case == "sentinel_incumbents":
        _, _, pid, pd_ = _merge_inputs(2, B, K, K, n, ties=True)
        t = [torch.full((B, K), n, dtype=torch.int32),
             torch.full((B, K), 3.0e38), pid, pd_]
    else:
        P = 0 if case == "no_proposals" else 1
        cid, cd, pid, pd_ = _merge_inputs(3, B, K, 4, n, ties=True)
        t = [cid, cd, pid[:, :P].contiguous(), pd_[:, :P].contiguous()]
    _assert_merge_bit_equal([a.to(cuda) for a in t], n)


@pytest.mark.cuda
def test_candidate_merge_kernel_on_the_build_shapes(cuda):
    """The merges of an NN-descent build at n 3,000 (K 64, S 16): the
    seeding merge (P 64, sentinel incumbents), the first local-join round
    (P 784) and a late round, and the reverse-edge pass (K = P = 64, all
    sentinel incumbents), each bit-equal to the plain merge."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3000, 32)).astype(np.float32))
    x_pad = TDB._pad_rows(x.to(cuda))
    n, K, S = 3000, 64, 16
    xsq = (x_pad * x_pad).sum(-1)
    ids = torch.full((n, K), n, dtype=torch.int32, device=cuda)
    dd = torch.full((n, K), 3.0e38, device=cuda)
    props0 = torch.from_numpy(rng.integers(0, n, (n, K)).astype(np.int32))
    props0 = props0.to(cuda)
    _assert_merge_bit_equal([ids, dd, props0, TDB._score(x_pad, xsq, props0,
                                                         n, None)], n)
    for rounds in (0, TDB.ROUNDS - 1):
        ids, dd = TDB._nn_descent(x_pad, K, rounds=rounds, S=S, seed=0,
                                  block=None)
        props = TDB._proposals(ids, n, S, local=True)
        assert props.shape[1] == 3 * S * S + S
        _assert_merge_bit_equal([ids, dd, props,
                                 TDB._score(x_pad, xsq, props, n, None)], n)
    cand = torch.cat([ids[:, :32], TDB._reverse_lists(ids[:, :32], n, 32)], 1)
    _assert_merge_bit_equal([torch.full_like(cand, n),
                             torch.full(cand.shape, 3.0e38, device=cuda), cand,
                             TDB._score(x_pad, xsq, cand, n, None)], n)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,ef,d,sentinel,p_fresh", [
    (64, 8, 16, 32, 3.0e38, 0.7), (128, 32, 128, 48, 3.0e38, 0.7),
    (33, 16, 48, 96, 3.0e38, 0.7), (128, 32, 128, 48, np.inf, 0.1)])
def test_expand_merge_kernel_bit_equal(cuda, B, R, ef, d, sentinel, p_fresh):
    """Bit-equal: the kernel sums in the plain version's lane order.  With
    +inf beam sentinels and few fresh candidates the sentinels reach the
    first ef slots (the kernel's padding must not)."""
    rng = np.random.default_rng(B + R)
    n = 5000
    bd = np.sort(rng.random((B, ef)).astype(np.float32) * 50, axis=1)
    bid = rng.integers(0, n, (B, ef)).astype(np.int32)
    bid[:, ef // 2:], bd[:, ef // 2:] = n, np.float32(sentinel)
    arrs = (rng.normal(size=(B, d)).astype(np.float32),
            rng.normal(size=(B, R, d)).astype(np.float32),
            rng.integers(0, n, (B, R)).astype(np.int32),
            rng.random((B, R)) < p_fresh, bid, bd, rng.random((B, ef)) > 0.5)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    before = launch_counts()["fused_expand_merge"]
    got = topk_kernel.fused_expand_merge(*t, n)
    assert launch_counts()["fused_expand_merge"] == before + 1
    for g, w in zip(got, TR.expand_merge_ref(*t, n)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_expand_merge_kernel_bf16_vectors(cuda):
    """bf16 neighbour vectors are widened in the kernel by their bits: the
    result is bit-equal to the plain version on the same bf16 input; other
    dtypes are refused."""
    rng = np.random.default_rng(7)
    B, R, ef, d, n = 64, 32, 128, 48, 5000
    bd = np.sort(rng.random((B, ef)).astype(np.float32) * 50, axis=1)
    bid = rng.integers(0, n, (B, ef)).astype(np.int32)
    bid[:, -8:], bd[:, -8:] = n, np.inf
    arrs = (rng.normal(size=(B, d)).astype(np.float32),
            rng.normal(size=(B, R, d)).astype(np.float32),
            rng.integers(0, n, (B, R)).astype(np.int32),
            rng.random((B, R)) < 0.7, bid, bd, rng.random((B, ef)) > 0.5)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    t[1] = t[1].to(torch.bfloat16)
    before = launch_counts()["fused_expand_merge"]
    got = topk_kernel.fused_expand_merge(*t, n)
    assert launch_counts()["fused_expand_merge"] == before + 1
    for g, w in zip(got, TR.expand_merge_ref(*t, n)):
        assert torch.equal(g, w)
    t[1] = t[1].to(torch.float16)
    with pytest.raises(TypeError, match="float32|bfloat16"):
        topk_kernel.fused_expand_merge(*t, n)


def _k6_case(B, R, ef, d, seed, integer=False, n=5000):
    """A sorted beam by (distance, id) with its last quarter sentinels
    (BIG, id n); ``integer``: small-integer vectors and distances and ids
    from a small range, so (distance, id) ties are everywhere."""
    rng = np.random.default_rng(seed)
    if integer:
        n = 40
        draw = lambda s: rng.integers(-2, 3, s).astype(np.float32)
        bd = rng.integers(0, 3 * d, (B, ef)).astype(np.float32)
    else:
        draw = lambda s: rng.normal(size=s).astype(np.float32)
        bd = rng.random((B, ef)).astype(np.float32) * 50
    bid = rng.integers(0, n, (B, ef)).astype(np.int32)
    o = np.lexsort((bid, bd), axis=1)
    bd, bid = np.take_along_axis(bd, o, 1), np.take_along_axis(bid, o, 1)
    s = ef - ef // 4
    bid[:, s:], bd[:, s:] = n, np.float32(3.0e38)
    return [draw((B, d)), draw((B, R, d)),
            rng.integers(0, n, (B, R)).astype(np.int32),
            rng.random((B, R)) < 0.6, bid, bd, rng.random((B, ef)) > 0.5], n


@pytest.mark.cuda
@pytest.mark.parametrize("case,B,R,ef,d,vectors", [
    ("unsorted beam", 64, 32, 128, 48, "float32"),
    ("unsorted beam", 64, 5, 32, 24, "bfloat16"),
    ("R 5", 64, 5, 128, 48, "float32"),
    ("R 48", 64, 48, 128, 48, "float32"),
    ("ef 16", 64, 32, 16, 48, "float32"),
    ("ef + R not a power of two", 64, 5, 20, 48, "bfloat16"),
    ("-0.0 in the beam", 64, 32, 64, 16, "float32"),
    ("integer ties", 64, 32, 128, 24, "float32"),
    ("integer ties", 64, 32, 48, 24, "bfloat16"),
    ("B 8192", 8192, 32, 128, 48, "float32"),
    ("B 8192", 8192, 32, 128, 48, "bfloat16"),
    ("NaN in the beam", 64, 2, 16, 24, "float32"),
    ("NaN in the beam", 64, 32, 128, 48, "bfloat16"),
    ("NaN in a beam of one", 64, 2, 1, 24, "float32"),
])
def test_expand_merge_kernel_routes_bit_equal(cuda, case, B, R, ef, d,
                                              vectors):
    """Bit-equal (ids, distance bits, flags) to the plain version on both of
    the kernel's routes: the warp sort and rank merge (R <= 32, a beam
    sorted by (distance, id)) and the block sort (R > 32, or a beam out of
    order, or holding a NaN); with ef < R, ef + R not a power of two, -0.0
    beside +0.0 and rows at distance exactly 0, ties in (distance, id)
    everywhere, a NaN beam distance (after every number, +inf included; at
    R 2 the NaN items reach the output; also in a beam of one), and at a
    batch where bytes decide."""
    arrs, n = _k6_case(B, R, ef, d, seed=B + R + ef + d,
                       integer=case in ("integer ties", "-0.0 in the beam"))
    q, nv, nid, fresh, bid, bd, bck = arrs
    if case == "unsorted beam":
        perm = np.random.default_rng(1).permuted(
            np.tile(np.arange(ef), (B, 1)), axis=1)
        bid, bd = np.take_along_axis(bid, perm, 1), np.take_along_axis(bd, perm, 1)
    if case == "-0.0 in the beam":
        nv[:, :6], fresh[:, :6] = q[:, None, :], True       # distance 0
        bd[:, :6] = np.array([-0.0, 0.0, -0.0, 0.0, 0.0, -0.0], np.float32)
        bid[:, :6] = np.array([1, 3, 3, 7, 9, 12], np.int32)
        bd[:, 6:] = np.maximum(bd[:, 6:], 1.0)
        o = np.lexsort((bid, bd), axis=1)
        bid, bd = np.take_along_axis(bid, o, 1), np.take_along_axis(bd, o, 1)
    if case == "NaN in the beam":
        bd[:, 3], bd[:, 5], bd[:, 9] = np.nan, np.nan, -np.float32(np.nan)
        bd[::2, -2:] = np.inf
        bid[:, 5] = 0
    if case == "NaN in a beam of one":
        bd[:, 0] = np.nan
    t = [torch.from_numpy(a).to(cuda) for a in (q, nv, nid, fresh, bid, bd, bck)]
    t[1] = t[1].to(getattr(torch, vectors))
    before = launch_counts()["fused_expand_merge"]
    got = topk_kernel.fused_expand_merge(*t, n)
    assert launch_counts()["fused_expand_merge"] == before + 1
    want = TR.expand_merge_ref(*t, n)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(got[2], want[2])


@pytest.mark.cuda
def test_expand_merge_kernel_refuses_what_it_cannot_hold(cuda):
    """ef + R = 4,000 pads to 4,096 sort items, 64 KB per query: more than
    the limit the kernel exports."""
    B, R, ef, d, n = 2, 32, 3968, 8, 100
    t = [torch.zeros((B, d), device=cuda),
         torch.zeros((B, R, d), device=cuda),
         torch.zeros((B, R), dtype=torch.int32, device=cuda),
         torch.ones((B, R), dtype=torch.bool, device=cuda),
         torch.full((B, ef), n, dtype=torch.int32, device=cuda),
         torch.full((B, ef), 3.0e38, device=cuda),
         torch.ones((B, ef), dtype=torch.bool, device=cuda)]
    with pytest.raises(ValueError, match="shared memory"):
        topk_kernel.fused_expand_merge(*t, n)


@pytest.mark.cuda
def test_nn_descent_build_on_card(cuda):
    """build_graph(method="nn_descent", device="cuda") at 5,000 points:
    the graph invariants, the merge through the kernel, and 10-NN list
    recall of the card's NN-descent near the CPU's."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5000, 32)).astype(np.float32)
    n, R = len(x), 16
    before = launch_counts()["fused_candidate_merge"]
    g = TGB.build_graph(x, R, method="nn_descent", seed=0, device=cuda)
    # seeding, the rounds and the reverse-edge pass
    assert launch_counts()["fused_candidate_merge"] == before + TDB.ROUNDS + 2
    nb = g.neighbors
    real = nb < n
    assert nb.shape == (n, R) and (nb >= 0).all() and (nb <= n).all()
    assert not (real & (nb == np.arange(n)[:, None])).any()
    for i in range(0, n, 7):
        kept = nb[i][real[i]]
        assert len(set(kept.tolist())) == len(kept)
    ids_g, _ = TDB.nn_descent(x, 10, rounds=4, seed=1, device=cuda)
    ids_c, _ = TDB.nn_descent(x, 10, rounds=4, seed=1, device="cpu")
    exact, _ = TGB.brute_knn(x, 10)
    rec = lambda ids: np.mean([len(set(a) & set(b)) / 10
                               for a, b in zip(ids, exact)])
    assert abs(rec(ids_g) - rec(ids_c)) <= 0.01


def _attn_inputs(B, Sq, Sk, H, Hkv, D, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, S, h, D), generator=g).to(dtype)
            for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv))]


# K8's forward by relative Frobenius error: a non-causal row averages
# hundreds of keys, so a typical |o| is near the elementwise bar of 3e-2,
# and a kernel that leaked the padded keys of a ragged tail tile, or dropped
# part of it, would move every output by 1-2% and still pass it.  bf16
# reads ~2.4e-3 (one output rounding, P rounded before P·V)
K8_REL_FROB = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _rel_frob(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [
    (2, 200, 200, 8, 2, 64),      # GQA 4, ragged tail of a 64-row tile
    (1, 1024, 1024, 32, 4, 64),   # the RAG path's head layout
    (2, 77, 77, 4, 1, 128),       # MQA, D 128
    (1, 130, 300, 4, 4, 128),     # Sq != Sk
    (1, 300, 45, 6, 3, 64),
    (1, 1024, 1024, 8, 2, 128),   # D 128 at S 1024
    (2, 333, 517, 8, 4, 64),      # neither a multiple of a 128-row tile
    (2, 100, 260, 4, 1, 16),      # the head dims of the fp32 kernel
    (1, 190, 70, 8, 2, 32),       # alone, bf16 included: GQA 4/1, Sq != Sk
    (2, 130, 333, 8, 2, 96),
    (1, 1500, 1500, 16, 16, 64),  # whisper's encoder: 11 tiles + 92 keys
])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, Hkv, D,
                                              causal, dtype):
    """K8 against its plain version: 1e-4 in fp32 (the fp32 kernel: 3xTF32
    products, about 22 bits of each operand), 3e-2 in bf16 (the reference's bar: the
    tensor-core kernel rounds P to bf16 before P·V, as the jnp model
    reference does, where the plain version keeps it fp32).  bf16 at D 64
    or 128 goes through the tensor-core kernel; fp32, and bf16 at D 16, 32
    and 96, through the fp32 kernel.  Both also within ``K8_REL_FROB``
    relative Frobenius error."""
    q, k, v = (t.to(cuda) for t in _attn_inputs(B, Sq, Sk, H, Hkv, D,
                                                 dtype, seed=Sq + Sk + D))
    before, before_bf16 = launch_counts()["flash_attention"], launch_counts()["flash_attention_bf16"]
    got = k8(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == before + 1
    assert launch_counts()["flash_attention_bf16"] == before_bf16 + (
        dtype == torch.bfloat16 and D in TENSOR_CORE_HEAD_DIMS)
    want = TR.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _rel_frob(got, want) <= K8_REL_FROB[dtype]


_K8_EDGES = [  # (tag, B, Sq, Sk, H, Hkv, q x)
    ("peaked", 2, 200, 300, 8, 2, 8.0),
    ("Sq 1", 1, 1, 77, 4, 2, 1.0),
    ("Sq 17", 2, 17, 130, 4, 1, 1.0),
    ("Sk 1", 1, 40, 1, 4, 4, 8.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("edge", [e[0] for e in _K8_EDGES])
@pytest.mark.parametrize("dtype,D", [
    (torch.float32, 16), (torch.float32, 64), (torch.float32, 128),
    (torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 96)])
def test_flash_attention_fp32_kernel_edges(cuda, dtype, D, edge, causal):
    """The fp32 kernel (3xTF32) within 1e-4 of the plain version in fp32,
    with peaked scores (q x 8) and at one query row, 17 rows (one partial
    warp tile) and one key; bf16 at the head dims it serves within 3e-2.
    None of them launches the bf16 tensor-core kernel."""
    _, B, Sq, Sk, H, Hkv, qx = next(e for e in _K8_EDGES if e[0] == edge)
    q, k, v = _attn_inputs(B, Sq, Sk, H, Hkv, D, torch.float32,
                           seed=Sq + Sk + D)
    q, k, v = ((q * qx).to(dtype).to(cuda), k.to(dtype).to(cuda),
               v.to(dtype).to(cuda))
    before, before_bf16 = launch_counts()["flash_attention"], launch_counts()["flash_attention_bf16"]
    got = k8(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == before + 1 and launch_counts()["flash_attention_bf16"] == before_bf16
    want = TR.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _rel_frob(got, want) <= K8_REL_FROB[dtype]


@pytest.mark.cuda
def test_flash_attention_kernel_takes_unaligned_views(cuda):
    """A contiguous bf16 view whose base is not 16-byte aligned (the
    tensor maps need aligned bases) gives the aligned copy's result."""
    q, k, v = (t.to(cuda) for t in _attn_inputs(1, 100, 100, 4, 2, 64,
                                                 torch.bfloat16, seed=1))
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    qv = buf[1:].view(q.shape)
    qv.copy_(q)
    assert qv.data_ptr() % 16 != 0
    torch.testing.assert_close(k8(qv, k, v), k8(q, k, v), rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = (t.to(cuda) for t in _attn_inputs(1, 8, 8, 4, 2, 80,
                                                 torch.float32, seed=0))
    with pytest.raises(ValueError, match="head dim"):
        k8(q, k, v)
    q, k, v = (t.to(cuda) for t in _attn_inputs(1, 8, 8, 4, 2, 64,
                                                 torch.float16, seed=0))
    with pytest.raises(TypeError, match="bfloat16"):
        k8(q, k, v)
    q, k, v = (t.to(cuda) for t in _attn_inputs(1, 8, 8, 4, 3, 64,
                                                 torch.float32, seed=0))
    with pytest.raises(ValueError, match="shapes"):
        k8(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,causal,tol", [
    (torch.bfloat16, (1, 1024, 1024, 32, 4, 64), True, 3e-2),
    (torch.bfloat16, (2, 300, 300, 8, 2, 64), True, 3e-2),
    (torch.bfloat16, (2, 256, 1500, 16, 16, 64), False, 3e-2),
    (torch.bfloat16, (1, 1500, 1500, 16, 16, 64), False, 3e-2),
    (torch.bfloat16, (1, 512, 512, 28, 4, 128), True, 3e-2),
    (torch.float32, (2, 256, 384, 8, 2, 16), False, 1e-4),
    (torch.float32, (1, 200, 200, 4, 1, 16), True, 1e-4)])
def test_attention_function_grad_matches_plain_autograd(cuda, dtype, shape,
                                                         causal, tol):
    """The training attention (``layers.FlashAttention``: K8 forward, the
    chunked FlashAttention-2 backward) against ``torch.autograd`` through
    K8's plain version on the same inputs: (dq, dk, dv) within ``tol``
    relative Frobenius error (bf16 through the tensor-core kernel at D 64;
    fp32 with TF32 off).  The backward never calls the plain version."""
    from repro_torch.models import layers as TL
    B, Sq, Sk, H, Hkv, D = shape
    q, k, v = (t.to(cuda) for t in _attn_inputs(B, Sq, Sk, H, Hkv, D, dtype,
                                                 seed=Sq + D))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)
                     ).to(dtype).to(cuda)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    before, before_bf16 = launch_counts()["flash_attention"], launch_counts()["flash_attention_bf16"]
    o = TL.flash_attention(qs, ks, vs, causal=causal, chunk=128)
    assert launch_counts()["flash_attention"] == before + 1
    assert launch_counts()["flash_attention_bf16"] == before_bf16 + (dtype == torch.bfloat16)
    got = torch.autograd.grad(o, (qs, ks, vs), do)
    assert launch_counts()["flash_attention"] == before + 1
    qp, kp, vp = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(TR.flash_attention_ref(qp, kp, vp,
                                                      causal=causal),
                               (qp, kp, vp), do)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("weights,tol", [("fp32", 1e-4), ("bf16", 3e-2)])
def test_train_step_on_the_card_matches_cpu(cuda, weights, tol):
    """The reduced dense model's gradient (head dim 16, GQA 4/2, remat on)
    on the card against the CPU's from the same weights: every leaf within
    ``tol`` relative Frobenius error (fp32 weights: measured ~1e-6; bf16:
    ~1e-2, bf16 products round at other places on the two devices), the
    loss within 1e-4.  A train step on the card launches K8 twice per
    layer (the forward and the remat recompute) and no more."""
    import copy
    import dataclasses
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.data import make_token_pipeline
    from repro_torch.models import steps as TS
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              n_kv_heads=2, remat=True)
    batch = make_token_pipeline(cfg, ShapeSpec("smoke", 64, 4, "train"),
                                seed=0).batch_at(0)
    cpu_p, _ = TS.init_train_state(cfg, seed=0, device="cpu")
    if weights == "fp32":
        cpu_p.float()
    card_p = copy.deepcopy(cpu_p).to(cuda)
    grad_step = TS.make_grad_step(cfg)
    want, mw = grad_step(cpu_p, batch)
    got, mg = grad_step(card_p, batch)
    assert abs(float(mg["loss"]) - float(mw["loss"])) <= 1e-4 * float(mw["loss"])
    for n, w in want.items():
        g = got[n].float().cpu()
        assert got[n].dtype == w.dtype
        err = float((g - w.float()).norm() / w.float().norm())
        assert err <= tol, (n, err)
    before = launch_counts()["flash_attention"]
    TS.make_train_step(cfg)(card_p, adamw_init(card_p), batch)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 2 * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-vl-7b",
                                  "whisper-medium", "zamba2-1.2b",
                                  "rwkv6-1.6b"])
def test_family_grads_on_the_card_match_cpu(cuda, arch):
    """Each family's reduced model (fp32 weights, remat on; whisper with 8
    synthetic frames, qwen2-vl with three distinct M-RoPE streams) on the
    card against the CPU from the same weights: loss within 1e-4, every
    leaf's gradient within 1e-4 relative Frobenius error (a MoE leaf may
    differ where a routing near-tie flips: 1e-3); K8 twice per attention of
    a monolithic step; a replayed step is bit-equal on the card."""
    import copy
    import dataclasses
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.data import make_token_pipeline
    from repro_torch.models import attention_calls
    from repro_torch.models import steps as TS
    from repro_torch.models.frontends import synthetic_frontend_embeds
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(reduced(get_config(arch)), remat=True)
    batch = make_token_pipeline(cfg, ShapeSpec("smoke", 64, 4, "train"),
                                seed=0).batch_at(0)
    if cfg.family == "encdec":
        batch["frontend_embeds"] = synthetic_frontend_embeds(
            cfg, 4, seed=1, device="cpu").float()
    if cfg.pos_type == "mrope":
        base = np.arange(64)[None].repeat(4, 0)
        batch["positions"] = np.stack([base, base // 8, base % 8]
                                      ).astype(np.int32)
    cpu_p, _ = TS.init_train_state(cfg, seed=0, device="cpu")
    cpu_p.float()
    card_p = copy.deepcopy(cpu_p).to(cuda)
    card_batch = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
                  for k, v in batch.items()}
    grad_step = TS.make_grad_step(cfg)
    want, mw = grad_step(cpu_p, batch)
    got, mg = grad_step(card_p, card_batch)
    assert abs(float(mg["loss"]) - float(mw["loss"])) <= 1e-4 * float(mw["loss"])
    tol = 1e-3 if cfg.is_moe else 1e-4
    # a leaf whose gradient is zero up to rounding (an attention key bias:
    # softmax ignores a per-row shift) is held against the largest leaf's
    scale = max(float(w.norm()) for w in want.values())
    for n, w in want.items():
        err = float((got[n].float().cpu() - w).norm()
                    / max(float(w.norm()), 1e-3 * scale))
        assert err <= tol, (n, err)
    step = TS.make_train_step(cfg, microbatches=1)
    state = adamw_init(card_p)
    snap = copy.deepcopy((card_p.state_dict(), state))
    before = launch_counts()["flash_attention"]
    step(card_p, state, card_batch)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 2 * attention_calls(cfg)
    first = {n: p.detach().clone() for n, p in card_p.named_parameters()}
    card_p.load_state_dict(snap[0])
    state = snap[1]
    step(card_p, state, card_batch)
    for n, p in card_p.named_parameters():
        assert torch.equal(p, first[n]), n


@pytest.mark.cuda
def test_model_and_rag_on_the_card(cuda):
    """The reduced dense model of the CPU tests (head dim 16, GQA 4/2)
    through forward, decode and the RAG pipeline on the card, against the
    same weights on the CPU: every layer's attention launches K8 once per
    forward, in the fp32 kernel (the bf16 kernel takes D 64 and
    128)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import IndexConfig, PilotANNIndex
    from repro_torch.models import decode_step, forward, init_caches, init_params
    from repro_torch.serving import RagPipeline

    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              n_kv_heads=2)
    assert cfg.head_dim == 16
    p_gpu = init_params(cfg, seed=0, device=cuda)
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_cpu.load_state_dict({k: v.cpu() for k, v in p_gpu.state_dict().items()})
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 70))
    before, before_bf16 = launch_counts()["flash_attention"], launch_counts()["flash_attention_bf16"]
    hg, _ = forward(p_gpu, cfg, tok)
    assert launch_counts()["flash_attention"] == before + cfg.n_layers
    assert launch_counts()["flash_attention_bf16"] == before_bf16
    hc, _ = forward(p_cpu, cfg, tok)
    rel = (hg.float().cpu() - hc.float()).abs().mean() / hc.float().abs().mean()
    assert float(rel) <= 2e-2
    caches = init_caches(p_gpu, cfg, 3, 8)
    lg, caches = decode_step(p_gpu, cfg, tok[:, :1], caches, 0)
    assert lg.shape == (3, 1, cfg.vocab_size) and caches["k"].is_cuda

    x = np.random.default_rng(1).normal(size=(3000, 32)).astype(np.float32)
    index = PilotANNIndex(IndexConfig(R=16, n_entry=512), x, device=cuda)
    with pytest.raises(ValueError, match="one device"):
        RagPipeline(index=index, params=p_cpu, cfg=cfg)
    rag = RagPipeline(index=index, params=p_gpu, cfg=cfg, max_new_tokens=4)
    before = launch_counts()["flash_attention"]
    out, ids = rag.generate(tok[:, :16], lambda i: np.full(16, i % 7))
    assert launch_counts()["flash_attention"] == before + cfg.n_layers       # one embed
    assert out.shape == (3, 4) and ((out >= 0) & (out < cfg.vocab_size)).all()
    assert ids.shape == (3, 4) and ((ids >= 0) & (ids < 3000)).all()


# ---------------------------------------------------------------------------
# The compiled-call layer: searches as CUDA graphs (core/compiled.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_index():
    """A small index built on the host and served from the card (its own
    compiled-search cache)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    from repro_torch.core import IndexConfig, PilotANNIndex
    from repro_torch.data import synthetic_vectors
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = synthetic_vectors(3000, 32, n_queries=128, seed=1)
    index = PilotANNIndex(IndexConfig(R=16, sample_ratio=0.35, svd_ratio=0.5,
                                      n_entry=512, build_method="exact"),
                          ds.vectors, device="cuda")
    return index, ds.queries


def _eager(index, params, queries, baseline=False, pad=True):
    """The eager program on the same padded bucket (or unpadded), sliced
    back."""
    from repro_torch.core import multistage as TM
    q = index.rotate_queries(queries)
    q, B = TM.pad_to_bucket(q) if pad else (q, q.shape[0])
    fn = TM.baseline_search if baseline else TM.multistage_search
    with torch.no_grad():
        ids, dists, stats = fn(index.arrays, params, q)
    return (ids[:B].cpu().numpy(), dists[:B].cpu().numpy(),
            {k: v[:B].cpu().numpy() for k, v in stats.items()})


def _bit_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [128, 13, 1])
@pytest.mark.parametrize("path", ["persistent", "per_hop", "baseline"])
def test_search_graphs_match_eager(card_index, B, path):
    """``search`` replays CUDA graphs: ids, distance bits and every stats
    key equal to the eager program on the same padded bucket; each kernel's
    counter counts the replayed launches (K1 and K3 once a batch on the
    persistent path, K3 once and K2 at least once per-hop, neither on the
    baseline; stage ③'s kernel once a batch on every path)."""
    from repro_torch.core import SearchParams
    from repro_torch.kernels import reset_launch_counts
    index, queries = card_index
    kw = {"persistent": {"use_persistent_traversal": True},
          "per_hop": {"use_pallas_traversal": True}, "baseline": {}}[path]
    params = SearchParams(k=10, ef=48, ef_pilot=48, **kw)
    baseline = path == "baseline"
    run = index.search_baseline if baseline else index.search
    index.warmup(params, baseline=baseline, buckets=(bucket_size(B),))
    reset_launch_counts()
    got = run(queries[:B], params)
    counts = launch_counts()
    _bit_equal(got, _eager(index, params, queries[:B], baseline))
    fes, k1, k2 = (counts["fes_distances"], counts["fused_pilot_search"],
                   counts["fused_traversal_hop"])
    assert {"persistent": (fes, k1, k2) == (1, 1, 0),
            "per_hop": fes == 1 and k1 == 0 and k2 >= 1,
            "baseline": (fes, k1, k2) == (0, 0, 0)}[path], counts
    assert counts["fused_final_search"] == 1, counts
    # a host test before each chunk of each loop the program yields: stage
    # ①'s per-hop loop; stage ③ is one launch, so the persistent and
    # baseline searches are one graph with none
    if path == "per_hop":
        assert counts["search.host_tests"] >= 1
        assert counts["search.rounds"] >= 1
    else:
        assert counts["search.host_tests"] == counts["search.rounds"] == 0
    # against the unpadded batch: other kernels for another number of rows
    # move the last bits (cancelling in qn + vn − 2·dot); ids stay, and
    # each distance within the fp32 bound of two summation orders
    flat = _eager(index, params, queries[:B], baseline, pad=False)
    np.testing.assert_array_equal(got[0], flat[0])
    q = index.rotate_queries(queries[:B])
    x = index.arrays["rot_vecs"][torch.from_numpy(got[0]).long().to(q.device)]
    bound = 2.5e-5 * ((q * q).sum(-1)[:, None] + (x * x).sum(-1)).cpu().numpy()
    assert (np.abs(got[1] - flat[1]) <= bound).all()


@pytest.mark.cuda
def test_set_pilot_dtype_drops_graphs(cuda):
    """After ``set_pilot_dtype`` the cache is empty and a search captures
    and replays the new encoding's graph: the eager pq result, not the
    fp32 graph's."""
    from repro_torch.core import IndexConfig, PilotANNIndex, SearchParams
    from repro_torch.data import synthetic_vectors
    ds = synthetic_vectors(3000, 32, n_queries=64, seed=2)
    index = PilotANNIndex(IndexConfig(R=16, sample_ratio=0.35, svd_ratio=0.5,
                                      n_entry=512, build_method="exact"),
                          ds.vectors, device="cuda")
    params = SearchParams(k=10, ef=48, ef_pilot=48,
                          use_persistent_traversal=True)
    q = ds.queries[:64]
    fp32 = index.search(q, params)
    index.set_pilot_dtype("pq")
    assert index.compile_count() == 0
    got = index.search(q, params)
    assert index.compile_count(params) == 1
    _bit_equal(got, _eager(index, params, q))
    # the pq pilot's own stage ①, not the fp32 graph's
    assert not np.array_equal(got[2]["pilot_dist"], fp32[2]["pilot_dist"])
    index.set_pilot_dtype("float32")
    _bit_equal(index.search(q, params), fp32)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,donate", [(1, False), (2, True), (3, True)])
def test_pipelined_search_on_the_card(card_index, depth, donate):
    """The pilot graph on one stream, the CPU-stage graph on another: ids
    and distance bits equal to ``search``; with donation the visited
    storage cycles through the pool."""
    from repro_torch.core import SearchParams, pipelined_search, split_stages
    from repro_torch.core.pipeline import is_consumed
    index, queries = card_index
    params = SearchParams(k=10, ef=48, ef_pilot=48,
                          use_persistent_traversal=True)
    batches = [index.rotate_queries(queries[i * 32:(i + 1) * 32])
               for i in range(4)]
    rec = []
    results, dt = pipelined_search(index.arrays, params, batches, depth=depth,
                                   donate=donate, record_into=rec)
    for i, (ids, dists) in enumerate(results):
        want = index.search(queries[i * 32:(i + 1) * 32], params)
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(dists.view(np.int32),
                                      want[1].view(np.int32))
    assert dt > 0 and sorted(r["batch"] for r in rec) == [0, 1, 2, 3]
    pilot, cpu = split_stages(index.arrays, params, donate=True)
    po = pilot(batches[0])
    ptr = po[2].data_ptr()
    cpu(batches[0], *po)
    assert all(is_consumed(t) for t in po)
    with pytest.raises(RuntimeError, match="consumed"):
        cpu(batches[0], *po)
    assert pilot(batches[0])[2].data_ptr() == ptr


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """No fallback: a program that syncs with the host inside a captured
    stretch fails its capture, and the failure raises."""
    from repro_torch.core import compiled

    def program(q):
        if bool((q > 0).any()):        # a host sync: not capturable
            q = q + 1
        return q * 2
        yield                           # a program (a generator)

    with pytest.raises(RuntimeError, match="capture"):
        compiled.compile_program(program, (torch.ones(8, 4, device=cuda),))


# ---------------------------------------------------------------------------
# Deletions: K1/K2's tombstone operand, the mutable index and the engine
# ---------------------------------------------------------------------------

def _sorted_masked_beam(tomb, bid, bd, bck, n):
    """The masked beam a bitmap-free launch must be given: dead entries at
    (n, +inf), then stably sorted by distance (what the kernel does)."""
    dead = tomb[bid.long().clamp(0, n)]
    bid, bd = bid.masked_fill(dead, n), bd.masked_fill(dead, float("inf"))
    o = torch.sort(bd, dim=1, stable=True).indices
    return bid.gather(1, o), bd.gather(1, o), bck.gather(1, o)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4",
                                   "pq"])
def test_traversal_kernels_tombstone_bit_equal(cuda, dtype):
    """K2 (W 1 and 3) and K1 with a bitmap: an all-false bitmap is bit-equal
    to no bitmap; 5% of ids deleted is bit-equal to the bitmap-free launch
    on the masked table and the masked, re-sorted beam, and to the plain
    version with the bitmap; no deleted id reaches a beam."""
    arrs, n = _hop_inputs(29, 16, 32, 47, "bloom", seed=5)
    if dtype == "float32":
        vec, scale, cb = arrs[2], None, None
    else:
        vec, scale, cb = _encode(arrs[2].numpy(), dtype)
    q, nbr, _, bid, bd, bck, vis = [a.to(cuda) for a in arrs[:2]] + [None] + [
        a.to(cuda) for a in arrs[3:]]
    vec = vec.to(cuda)
    side = dict(vec_scale=None if scale is None else scale.to(cuda),
                vec_codebook=None if cb is None else cb.to(cuda))
    rng = np.random.default_rng(11)
    dead = np.zeros(n + 1, bool)
    dead[rng.choice(n, n // 20, replace=False)] = True
    tomb = torch.from_numpy(dead).to(cuda)
    none = torch.zeros(n + 1, dtype=torch.bool, device=cuda)
    mnbr = torch.where(tomb[nbr.long()], torch.full_like(nbr, n), nbr)
    mb = _sorted_masked_beam(tomb, bid, bd, bck, n)
    calls = [(traversal_kernel.fused_traversal_hop, TR.traversal_hop_ref,
              dict(width=W)) for W in (1, 3)]
    calls.append((traversal_kernel.fused_pilot_search, TR.pilot_search_ref,
                  dict(rounds=128, width=2)))
    for fn, plain, kw in calls:
        bare = fn(q, nbr, vec, bid, bd, bck, vis, n, **kw, **side)
        zero = fn(q, nbr, vec, bid, bd, bck, vis, n, tombstone=none, **kw,
                  **side)
        for a, b in zip(bare, zero):
            assert torch.equal(a, b)
        got = fn(q, nbr, vec, bid, bd, bck, vis, n, tombstone=tomb, **kw,
                 **side)
        masked = fn(q, mnbr, vec, *mb, vis, n, **kw, **side)
        want = plain(q, nbr, vec, bid, bd, bck, vis, n, tombstone=tomb, **kw,
                     **side)
        for a, b, c in zip(got, masked, want):
            assert torch.equal(a, b) and torch.equal(a, c)
        beam = got[0]
        assert not tomb[beam.long().clamp(0, n)][beam < n].any()


@pytest.mark.cuda
def test_inplace_delete_between_replays_recaptures_nothing(cuda):
    """A delete between two replays of the captured search changes the
    results (the deleted ids leave) and captures nothing new; the engine's
    stage pair sees it too, with no stage rebuild."""
    from repro_torch.core import IndexConfig, SearchParams, SegmentedIndex
    from repro_torch.data import synthetic_vectors
    from repro_torch.serving import ServeParams, ThroughputEngine
    ds = synthetic_vectors(3000, 32, n_queries=64, seed=4)
    s = SegmentedIndex(IndexConfig(R=16, sample_ratio=0.35, svd_ratio=0.5,
                                   n_entry=512, build_method="exact"),
                       ds.vectors, device="cuda")
    params = SearchParams(k=10, ef=48, ef_pilot=48,
                          use_persistent_traversal=True)
    q = ds.queries[:64]
    eng = ThroughputEngine(s, params, ServeParams(buckets=(64,), depth=2,
                                                  max_wait_s=0.0))
    g0, _, _ = s.search(q, params)
    e0, _, _ = eng.serve(q)
    fns = dict(s.base._search_fns)
    np.testing.assert_array_equal(e0, g0)
    dead = np.unique(g0[:, :3])
    eng.submit_delete(dead)
    eng.flush_mutations()
    g1, d1, _ = s.search(q, params)
    assert not np.isin(g1, dead).any() and not np.array_equal(g1, g0)
    assert dict(s.base._search_fns) == fns          # the same programs
    assert eng.stats["stage_rebuilds"] == 0
    e1, ed1, _ = eng.serve(q)
    np.testing.assert_array_equal(e1, g1)
    np.testing.assert_array_equal(ed1.view(np.int32), d1.view(np.int32))


@pytest.mark.cuda
def test_engine_on_the_card_matches_search(card_index):
    """The engine's stage graphs against ``search``'s at bucket 128: ids and
    distance bits equal; K1 and stage ③'s kernel launched once a batch."""
    from repro_torch.core import SearchParams
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.serving import ServeParams, ThroughputEngine
    index, queries = card_index
    params = SearchParams(k=10, ef=48, ef_pilot=48,
                          use_persistent_traversal=True)
    eng = ThroughputEngine(index, params, ServeParams(depth=2, donate=True,
                                                      max_wait_s=0.0))
    reset_launch_counts()
    ids, dists, stats = eng.serve(queries[:128])
    assert stats["bucket_hist"] == {128: 1}
    assert launch_counts()["fused_pilot_search"] == 1
    assert launch_counts()["fused_final_search"] == 1
    want = index.search(queries[:128], params)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(dists.view(np.int32),
                                  want[1].view(np.int32))
