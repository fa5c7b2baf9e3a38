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
from repro_torch.kernels import launch_counts
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
    before = launch_counts()["flash_attention"]
    got = _port(t_flash, arrs, dtype, causal)
    assert launch_counts()["flash_attention"] == before
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


def _tensor_core_rounding(q, k, v, *, causal, tile=128):
    """The bf16 tensor-core K8's arithmetic in plain torch: fp32 scores of
    the bf16 inputs, 128-key tiles with an fp32 running max and sum (the sum
    over the fp32 p), P rounded to bf16 only as the operand of P·V (exact
    bf16 products summed in fp32), output acc / max(l, 1e-30) in bf16."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kh = torch.arange(H) // (H // Hkv)
    qf = q.float().permute(0, 2, 1, 3)                        # (B, H, Sq, D)
    kf = k.float().permute(0, 2, 1, 3)[:, kh]
    vf = v.float().permute(0, 2, 1, 3)[:, kh]
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, D))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, tile):
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2) / np.sqrt(D)
        cols = torch.arange(k0, min(k0 + tile, Sk))[None, :]
        if causal:
            s = s.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    o = acc / l.clamp_min(1e-30)
    return o.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D", [(200, 200, 64), (130, 300, 128)])
def test_tensor_core_rounding_within_the_bars(Sq, Sk, D, causal):
    """Rounding P to bf16 before P·V (the tensor-core kernel's one change
    of contract) stays within 3e-2 of the plain version, which keeps P in
    fp32, and of the jnp reference in bf16, which rounds P too."""
    arrs = _inputs(2, Sq, Sk, 4, 2, D, seed=Sq + Sk + D)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = _tensor_core_rounding(q, k, v, causal=causal).float().numpy()
    plain = flash_attention_ref(q, k, v, causal=causal).float().numpy()
    np.testing.assert_allclose(got, plain, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, _reference(arrs, "bfloat16", causal),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
