"""PyTorch port vs the JAX reference: the expand-merge (``kernels/ref.
expand_merge_ref``, the plain version of ``kernels.topk_kernel.
fused_expand_merge``), on the same numpy inputs as the reference's own
sweep.  The JAX side runs its jnp oracle and its Pallas kernel in interpret
mode; the CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ref import expand_merge_ref as j_expand_merge_ref
from repro.kernels.topk_kernel import fused_expand_merge as j_expand_merge
from repro_torch.kernels import launch_counts, topk_kernel

torch.set_num_threads(1)


def _case(B, R, ef, d, seed, n=5000, ties=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, d)).astype(np.float32)
    nv = rng.normal(size=(B, R, d)).astype(np.float32)
    nid = rng.integers(0, n, (B, R)).astype(np.int32)
    fresh = rng.random((B, R)) > 0.3
    bid = rng.integers(0, n, (B, ef)).astype(np.int32)
    bd = np.sort(rng.random((B, ef)).astype(np.float32) * 50, axis=1)
    bck = rng.random((B, ef)) > 0.5
    if ties:
        # beam sentinels (BIG, id n, unchecked) tie on (distance, id) with
        # the candidates that are not fresh (BIG, id n, checked): only the
        # position order tells their flags apart; half the beam is empty, so
        # the ties reach the first ef slots
        bid[:, ef // 2:] = n
        bd[:, ef // 2:] = np.float32(3.0e38)
        bck[:, ef // 2:] = False
    return q, nv, nid, fresh, bid, bd, bck, n


@pytest.mark.parametrize("B,R,ef,d,ties", [
    (64, 8, 16, 32, False), (128, 16, 32, 64, False),
    (128, 32, 64, 128, False), (64, 16, 48, 96, True)])
def test_expand_merge_matches_reference(B, R, ef, d, ties):
    """(b) Ids and checked flags equal to the reference's oracle and its
    Pallas kernel in interpret mode; distances at rtol 1e-5, atol 1e-5 (the
    port sums in the CUDA kernel's lane order, the reference with einsum)."""
    *arrs, n = _case(B, R, ef, d, seed=B + R, ties=ties)
    before = launch_counts()["fused_expand_merge"]
    got = topk_kernel.fused_expand_merge(*(torch.from_numpy(a) for a in arrs), n)
    assert launch_counts()["fused_expand_merge"] == before
    jargs = [jnp.asarray(a) for a in arrs]
    for want in (j_expand_merge_ref(*jargs, n),
                 j_expand_merge(*jargs, n, interpret=True)):
        wi, wd, wc = (np.asarray(w) for w in want)
        np.testing.assert_array_equal(got[0].numpy(), wi)
        np.testing.assert_array_equal(got[2].numpy(), wc)
        np.testing.assert_allclose(got[1].numpy(), wd, rtol=1e-5, atol=1e-5)
