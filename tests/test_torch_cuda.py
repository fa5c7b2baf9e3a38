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
from repro_torch.kernels import fes_kernel, ops, ref as TR, traversal_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _hop_inputs(B_, R, ef, d, mode, seed, n=600, id_dtype=np.int16):
    """Random regular digraph, random vectors, a sorted random beam with
    sentinels, and the beam inserted into the visited filter."""
    rng = np.random.default_rng(seed)
    nbr = np.stack([rng.choice(n, R, replace=False) for _ in range(n)])
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
    before = traversal_kernel.fused_traversal_hop.launches
    got = traversal_kernel.fused_traversal_hop(*t, n, width=W, visited_mode=mode)
    want = TR.traversal_hop_ref(*t, n, width=W, visited_mode=mode)
    assert traversal_kernel.fused_traversal_hop.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = traversal_kernel.fused_pilot_search(*t, n, rounds=128, width=W,
                                              visited_mode=mode)
    want = TR.pilot_search_ref(*t, n, rounds=128, width=W, visited_mode=mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_traversal_kernel_refuses_what_it_cannot_hold(cuda):
    arrs, n = _hop_inputs(4, 8, 16, 16, "bloom", seed=0)
    t = [a.to(cuda) for a in arrs]
    big = torch.zeros((4, 3_000_000), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        traversal_kernel.fused_traversal_hop(*t[:6], big, n)
    with pytest.raises(NotImplementedError, match="A5"):
        traversal_kernel.fused_traversal_hop(
            t[0], t[1], t[2].to(torch.bfloat16), *t[3:], n)


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
