"""Stage 0 at the main path's layout, port against the JAX reference.

``ops.fes_select`` gives every cluster B slots (``group_queries`` with
capacity B), so most slots of the grouped batch are all-zero rows.  The
FES kernels (``csrc/fes.cu``) write such a row without its products: it is
the entries' own ``en`` (K3/K4) or the zero query's table summed over the
codes (K5).  These tests hold, for every entry encoding (int4 at an even
and an odd width), the plain version against the reference's Pallas
kernel in interpret mode on that layout, the zero-row identity the kernels
rely on, and the stage-0 ids against the reference's ``fes_select``.  The
CUDA kernels themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import quant as JQ
from repro.kernels.fes_kernel import fes_distances as j_fes_distances
from repro.kernels.ops import fes_select as j_fes_select
from repro_torch.kernels import fes_kernel, ops, ref as TR

torch.set_num_threads(1)

R, B, C, L = 8, 32, 128, 8          # 8 clusters x 32 slots, 32 queries
CASES = [("float32", 48), ("bfloat16", 48), ("int8", 48), ("int4", 48),
         ("int4", 47), ("pq", 48)]


def _layout(dtype, d, seed):
    """Seeded queries, centroids and (R, C, d) entries encoded by the
    reference; the port's grouped batch (capacity B) and tensors."""
    rng = np.random.default_rng(seed)
    cent = rng.normal(size=(R, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    x = rng.normal(size=(R, C, d)).astype(np.float32)
    data, side = JQ.quantize(x, dtype)
    data = np.asarray(data)
    tdata = torch.from_numpy(data.view(np.int16) if dtype == "bfloat16"
                             else data)
    if dtype == "bfloat16":
        tdata = tdata.view(torch.bfloat16)
    scale, cb = (None, side) if dtype == "pq" else (side, None)
    jside = dict(scale=None if scale is None else jnp.asarray(scale),
                 codebook=None if cb is None else jnp.asarray(cb))
    tside = dict(scale=None if scale is None else torch.from_numpy(scale),
                 codebook=None if cb is None else torch.from_numpy(cb))
    qg, _ = ops.group_queries(torch.from_numpy(q), torch.from_numpy(cent), B)
    return rng, q, cent, data, jside, tdata, tside, qg


def _zero_rows(qg):
    return (qg == 0).all(-1)                        # (R, B)


@pytest.mark.parametrize("dtype,d", CASES)
def test_plain_matches_reference_kernel_on_grouped_batch(dtype, d):
    _, _, _, data, jside, tdata, tside, qg = _layout(dtype, d, seed=3)
    assert float(_zero_rows(qg).float().mean()) >= 0.8     # mostly empty
    want = np.asarray(j_fes_distances(jnp.asarray(qg.numpy()),
                                      jnp.asarray(data), interpret=True,
                                      **jside))
    for fn in (TR.fes_distances_ref, fes_kernel.fes_distances):
        got = fn(qg, tdata, **tside)
        assert got.dtype == torch.float32 and got.shape == (R, B, C)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * d)


@pytest.mark.parametrize("dtype,d", CASES)
def test_zero_slot_rows_are_the_entries_own_values(dtype, d):
    """An all-zero slot's row is exactly the plain version's ``en``
    (K3/K4) or ``Σ_s cn[code_s]`` summed from +0 with s ascending (K5):
    what the kernels write for it without the products.  The reference
    kernel's rows agree within the tolerance above."""
    _, _, _, data, jside, tdata, tside, qg = _layout(dtype, d, seed=5)
    got = TR.fes_distances_ref(qg, tdata, **tside)
    cb = tside["codebook"]
    if cb is None:
        e = TR.decode_lanes(tdata, tside["scale"])
        own = (e * e).sum(-1)                                  # (R, C)
    else:
        cn = (cb * cb).sum(0)
        ksub = cb.shape[1] // tdata.shape[-1]
        own = torch.zeros((R, C))
        for s in range(tdata.shape[-1]):
            own = own + cn[ksub * s + tdata[..., s].long()]
    zero = _zero_rows(qg)
    rows = own[:, None, :].expand(R, B, C)[zero]
    assert zero.sum() > 0
    assert torch.equal(got[zero].view(torch.int32), rows.view(torch.int32))
    want = np.asarray(j_fes_distances(jnp.asarray(qg.numpy()),
                                      jnp.asarray(data), interpret=True,
                                      **jside))
    np.testing.assert_allclose(want[zero.numpy()], rows.numpy(), rtol=1e-4,
                               atol=1e-4 * d)


@pytest.mark.parametrize("dtype,d", CASES)
def test_fes_select_ids_match_reference_with_empty_slots(dtype, d):
    """Stage 0 through the card path's wrapper (plain on the CPU) against
    the reference's ``fes_select`` (Pallas, interpret mode), capacity B:
    7 of every 8 slots empty, a tenth of the entries invalid."""
    rng, q, cent, data, jside, tdata, tside, _ = _layout(dtype, d, seed=7)
    eid = rng.permutation(5000)[:R * C].reshape(R, C).astype(np.int32)
    val = rng.random((R, C)) > 0.1
    want_ids, want_d = j_fes_select(
        jnp.asarray(q), jnp.asarray(cent), jnp.asarray(data),
        jnp.asarray(eid), jnp.asarray(val), L=L, interpret=True,
        entries_scale=jside["scale"], entries_codebook=jside["codebook"])
    ids, dists = ops.fes_select(
        torch.from_numpy(q), torch.from_numpy(cent), tdata,
        torch.from_numpy(eid), torch.from_numpy(val), L=L,
        entries_scale=tside["scale"], entries_codebook=tside["codebook"])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(dists.numpy(), np.asarray(want_d), rtol=1e-4,
                               atol=1e-4 * d)
