"""A model of K8's fp32 kernel arithmetic (``csrc/flash_attention.cu``,
``flash_fwd_fp32_kernel``) on the CPU: 3xTF32 on the tensor cores.

Every fp32 operand of the two products is split as x = hi + lo, hi = x
rounded to TF32 (10 mantissa bits) to nearest with ties away from zero, on
the bits, and lo = x - hi, which the tensor core reads truncated to TF32
(it ignores the low 13 bits of a TF32 operand); a product a·b is
a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (the small terms first, a_lo·b_lo
dropped), accumulated in fp32.  The model runs the kernel's online
softmax over 32-key tiles with q·kᵀ and P·V so computed, and holds the
result against the port's plain version (``kernels/ref.
flash_attention_ref``) and the JAX reference's attention at 1e-4, the
card's bar, at the card tests' fp32 shapes, with peaked scores among
them; one-term TF32 (hi·hi alone) misses that bar.  bf16 inputs are exact
in TF32 (lo = 0), so the kernel skips their lo products: the model shows
that skipping them changes no bit.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models.layers import flash_attention as j_flash
from repro_torch.kernels.ref import NEG_INF, flash_attention_ref

torch.set_num_threads(1)

KEYS = 32   # keys per tile (kKeys in the kernel)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 to nearest, ties away from zero: add half of the 13
    dropped bits to the magnitude, then clear them."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor core reads from fp32 bits: the low 13
    bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, truncate(x - hi)


def product(a, b, terms: int):
    """a @ b with each operand split into TF32 parts, ``terms`` 3 (the
    kernel's fp32 route) or 1 (plain TF32)."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def model(q, k, v, *, causal: bool, terms: int = 3):
    """The kernel's attention: per 32-key tile S = q·kᵀ (split products)
    times D^-½, the mask at NEG_INF, running max m and sum l, acc = acc·corr
    + P·V (split products), then acc / max(l, 1e-30)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, H, Sq), NEG_INF)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, D))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, KEYS):
        kt, vt = kf[:, :, k0:k0 + KEYS], vf[:, :, k0:k0 + KEYS]
        s = product(qf, kt.transpose(-1, -2), terms) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(cols > rows, NEG_INF)
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + product(p, vt, terms)
        m = mx
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _inputs(B, Sq, Sk, H, Hkv, D, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, D))
                                .astype(np.float32))
               for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    return q * q_scale, k, v


def test_split_is_exact_to_21_bits():
    """hi + lo recovers x to within 2^-21 of |x|; hi and lo carry no bits
    below TF32's; a bf16 value splits with lo = 0."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32)) * 1e3
    hi, lo = split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    xb = x.to(torch.bfloat16).float()
    hb, lb = split(xb)
    assert torch.equal(hb, xb) and (lb == 0).all()
    # ties go away from zero: 1 + 2^-11 (half a TF32 ulp) rounds up
    t = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], dtype=torch.float32)
    assert torch.equal(tf32(t), torch.tensor([1 + 2.0 ** -10,
                                              -(1 + 2.0 ** -10)]))


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,q_scale", [
    (2, 384, 640, 16, 4, 128, False, 1.0),   # chip_smoke phase 6
    (2, 384, 640, 16, 4, 128, False, 8.0),   # peaked scores
    (2, 200, 200, 8, 2, 64, True, 1.0),
    (2, 77, 77, 4, 1, 128, True, 1.0),
    (1, 130, 300, 4, 4, 128, False, 1.0),
    (1, 300, 45, 6, 3, 64, True, 1.0),
    (2, 333, 517, 8, 4, 64, False, 1.0),
    (2, 100, 260, 4, 1, 16, True, 8.0),
    (1, 190, 70, 8, 2, 32, False, 1.0),
    (2, 130, 333, 8, 2, 96, True, 1.0),
    (1, 17, 1, 4, 2, 64, True, 8.0),         # Sk 1
    (1, 1, 65, 4, 2, 16, False, 8.0),        # Sq 1
])
def test_three_terms_hold_the_bar_and_one_does_not(B, Sq, Sk, H, Hkv, D,
                                                   causal, q_scale):
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, D, seed=Sq + Sk + D, q_scale=q_scale)
    want = flash_attention_ref(q, k, v, causal=causal)
    got = model(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if Sk > 1:  # one key: p is 1 and the output v, at any precision
        one = model(q, k, v, causal=causal, terms=1)
        assert not torch.allclose(one, want, rtol=1e-4, atol=1e-4)
    if (B, Sq, Sk) == (2, 384, 640) and q_scale == 1.0:
        jw = j_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                     causal=causal, chunk_q=64, chunk_k=64)
        np.testing.assert_allclose(got.numpy(), np.asarray(jw), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("D", [16, 32, 96])
def test_bf16_inputs_skip_only_zero_products(D):
    """bf16 q, k, v split with lo = 0, so S = q_hi·k_hi and P·V = p_lo·v_hi
    + p_hi·v_hi (the kernel's bf16 route) equal the three-term products
    bit for bit; the result is within bf16's 3e-2 of the plain version."""
    q, k, v = (t.to(torch.bfloat16) for t in
               _inputs(2, 60, 90, 4, 2, D, seed=D))
    a, b = q.float()[0, :, 0], k.float()[0, :, 0].T
    assert torch.equal(product(a, b, 3), tf32(a) @ tf32(b))
    p = torch.rand(60, 90)
    vh = v.float()[0, :, 0]
    ph, pl = split(p)
    assert torch.equal(product(p, vh, 3), pl @ vh + ph @ vh)
    got = model(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
