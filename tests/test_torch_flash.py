"""K8's plain version and the CPU route of its wrapper against the JAX
reference's attention, ``repro.models.layers.flash_attention`` (the Pallas
kernel ``flash_attention_tpu`` does not run on the installed jax, so the
jnp function it was validated against is the reference).

The JAX function rounds the probabilities to v's dtype before P·V; K8 and
its plain version keep them fp32, as the Pallas kernel does.  So bf16 is
held at the reference's own bar for its kernel (3e-2,
``tests/test_kernels_flash.py``) and fp32 at 2e-5 (summation order only).
The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models.layers import flash_attention as j_flash
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import layers as TL

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv))]


def _reference(arrs, dtype, causal):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(a).astype(jdt) for a in arrs)
    o = j_flash(q, k, v, causal=causal, chunk_q=64, chunk_k=64)
    return np.asarray(o.astype(jnp.float32))


def _port(fn, arrs, dtype, causal):
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    o = fn(q, k, v, causal=causal)
    assert o.dtype == tdt and o.shape == q.shape
    return o.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 40, 4, 4, 16),      # one tile, not a multiple of it
    (2, 128, 4, 2, 64),     # GQA group 2
    (1, 200, 4, 1, 128),    # MQA, ragged tail
    (2, 40, 4, 2, 128),
    (1, 128, 4, 1, 16),
    (2, 200, 4, 4, 64),
])
def test_plain_flash_matches_reference(B, S, H, Hkv, D, causal, dtype):
    arrs = _inputs(B, S, S, H, Hkv, D, seed=S + H + Hkv + D)
    want = _reference(arrs, dtype, causal)
    got = _port(flash_attention_ref, arrs, dtype, causal)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,causal", [(40, 200, False), (200, 40, False),
                                          (128, 40, True)])
def test_wrapper_cpu_route_matches_reference(Sq, Sk, causal, dtype):
    """The wrapper on CPU tensors runs the plain version (and launches
    nothing); Sq != Sk, with q and k aligned at position 0 when causal."""
    arrs = _inputs(2, Sq, Sk, 4, 2, 64, seed=Sq * Sk)
    before = t_flash.launches
    got = _port(t_flash, arrs, dtype, causal)
    assert t_flash.launches == before
    want = _reference(arrs, dtype, causal)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_array_equal(
        got, _port(flash_attention_ref, arrs, dtype, causal))


def test_model_layer_routes_to_the_kernel_wrapper(monkeypatch):
    """``models.layers.flash_attention`` is K8's wrapper: what it returns
    and whom it calls."""
    import repro_torch.models.layers as layers_mod
    calls = []

    def spy(q, k, v, *, causal):
        calls.append(causal)
        return flash_attention_ref(q, k, v, causal=causal)

    monkeypatch.setattr(layers_mod, "_k8", spy)
    arrs = _inputs(1, 40, 40, 4, 2, 16, seed=0)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    np.testing.assert_array_equal(TL.flash_attention(q, k, v, causal=False),
                                  flash_attention_ref(q, k, v, causal=False))
    assert calls == [False]


def test_causal_rows_see_only_the_past():
    """Changing keys and values after position t leaves row t unchanged."""
    arrs = _inputs(1, 90, 90, 4, 2, 16, seed=5)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    k2, v2 = k.clone(), v.clone()
    k2[:, 50:] += 3.0
    v2[:, 50:] -= 2.0
    a = t_flash(q, k, v, causal=True)
    b = t_flash(q, k2, v2, causal=True)
    torch.testing.assert_close(a[:, :50], b[:, :50], rtol=0, atol=0)
    assert not torch.equal(a[:, 50:], b[:, 50:])
