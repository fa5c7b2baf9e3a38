"""The port's sub-quadratic sequence layers (``repro_torch.models.ssm``,
Mamba2's SSD scan and block; ``repro_torch.models.rwkv``, RWKV6's WKV
recurrence, time-mix and channel-mix) and M-RoPE
(``layers.rope_angles``) against the reference, against naive
step-by-step recurrences, and under chunk-size invariance (mirroring
``tests/test_sequence_models.py``).

Tolerances: fp32 against the reference 1e-4 (summation order only);
against the naive recurrences 2e-4 (Mamba2) and 3e-4 (WKV6), and between
chunk sizes 1e-4, the reference's own bars; bf16-weight blocks in fp32
arithmetic (the weights carried as bf16, then cast) 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.models import layers as JL
from repro.models import rwkv as JR
from repro.models import ssm as JSm
from repro_torch import configs as TC
from repro_torch.models import layers as TL
from repro_torch.models import rwkv as TR
from repro_torch.models import ssm as TSm
from repro_torch.models.convert import _tensor

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _mamba_inputs(seed, B, L, H, P, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.5, size=(B, L, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, H, P, N)).astype(np.float32))


def _wkv_inputs(seed, B, L, H, D):
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=(B, L, H, D)).astype(np.float32)
             for _ in range(3)]
            + [-rng.uniform(0.05, 2.0, size=(B, L, H, D)).astype(np.float32),
               rng.normal(size=(H, D)).astype(np.float32),
               rng.normal(size=(B, H, D, D)).astype(np.float32)])


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,chunk", [(37, 8), (128, 128), (200, 64)])
def test_mamba2_scan_matches_reference(L, chunk):
    """fp32, a ragged last chunk, from an initial state."""
    xh, dt, A, Bm, Cm, s0 = _mamba_inputs(0, 2, L, 3, 4, 5)
    jy, jf = JSm.mamba2_scan(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                             chunk=chunk, init_state=jnp.asarray(s0))
    ty, tf = TSm.mamba2_scan(*map(_t, (xh, dt, A, Bm, Cm)), chunk=chunk,
                             init_state=_t(s0))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tf), _np(jf), rtol=1e-4, atol=1e-4)


def test_mamba2_scan_bf16_operands_match_reference():
    """The block's operand types: xh, B, C bf16, dt and A fp32 (CB a bf16
    product; everything after it fp32, as jnp promotes)."""
    xh, dt, A, Bm, Cm, _ = _mamba_inputs(1, 2, 96, 3, 4, 5)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (xh, Bm, Cm)]
    tb = [_tensor(np.asarray(a)) for a in jb]
    jy, jf = JSm.mamba2_scan(jb[0], jnp.asarray(dt), jnp.asarray(A), jb[1],
                             jb[2], chunk=32)
    ty, tf = TSm.mamba2_scan(tb[0], _t(dt), _t(A), tb[1], tb[2], chunk=32)
    assert ty.dtype == torch.float32 == tf.dtype
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tf), _np(jf), rtol=1e-4, atol=1e-4)


def test_mamba2_chunked_matches_naive_recurrence():
    xh, dt, A, Bm, Cm, _ = _mamba_inputs(0, 2, 37, 3, 4, 5)
    y, final = TSm.mamba2_scan(*map(_t, (xh, dt, A, Bm, Cm)), chunk=8)
    S = np.zeros((2, 3, 4, 5), np.float32)
    ys = []
    for t in range(37):
        dA = np.exp(dt[:, t, :, None, None] * A[None, :, None, None])
        S = dA * S + (dt[:, t, :, None, None] * xh[:, t, :, :, None]
                      * Bm[:, t, None, None, :])
        ys.append(np.einsum("bhpn,bn->bhp", S, Cm[:, t]))
    np.testing.assert_allclose(_np(y), np.stack(ys, 1), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(final), S, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [8, 32])
def test_mamba2_chunk_size_invariance(chunk):
    xh, dt, A, Bm, Cm, _ = _mamba_inputs(3, 1, 48, 2, 4, 6)
    args = list(map(_t, (xh, dt, A, Bm, Cm)))
    y1, f1 = TSm.mamba2_scan(*args, chunk=chunk)
    y2, f2 = TSm.mamba2_scan(*args, chunk=48)
    np.testing.assert_allclose(_np(y1), _np(y2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(f1), _np(f2), rtol=1e-4, atol=1e-4)


def test_causal_conv_and_segsum_match_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for state in (None, st):
        jy, js = JSm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b),
                                  None if state is None else jnp.asarray(state))
        ty, ts = TSm._causal_conv(_t(x), _t(w), _t(b),
                                  None if state is None else _t(state))
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(_np(ts), _np(js))
    seg = rng.normal(size=(3, 7)).astype(np.float32)
    np.testing.assert_allclose(_np(TSm._segsum(_t(seg))),
                               _np(JSm._segsum(jnp.asarray(seg))), rtol=1e-6,
                               atol=1e-6)


def _cfgs(arch, **kw):
    return (dataclasses.replace(JC.reduced(JC.get_config(arch)), **kw),
            dataclasses.replace(TC.reduced(TC.get_config(arch)), **kw))


def _carry(module: torch.nn.Module, tree: dict, prefix: str = "") -> None:
    """Copy a reference param dict into ``module``'s parameters of the same
    names (bf16 leaves as bits)."""
    named = dict(module.named_parameters())
    with torch.no_grad():
        for k, v in tree.items():
            if isinstance(v, dict):
                _carry(module, v, f"{prefix}{k}.")
            else:
                named[prefix + k].copy_(_tensor(np.asarray(v)))


def test_mamba2_block_matches_reference():
    """The reduced zamba2's Mamba2 block on the reference's weights (fp32):
    the prefill, then 6 decode steps from zero states written in place,
    each step's output and state as the reference's."""
    jcfg, tcfg = _cfgs("zamba2-1.2b")
    jp = JSm.init_mamba2(jax.random.PRNGKey(0), jcfg)
    m = TSm.Mamba2(tcfg, device="cpu")
    _carry(m, jp)
    m = m.float()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    x = np.random.default_rng(6).normal(size=(2, 24, jcfg.d_model)
                                        ).astype(np.float32)
    jblock = jax.jit(JSm.mamba2_block, static_argnums=2)
    jy, _ = jblock(jp, jnp.asarray(x), jcfg)
    ty, none = TSm.mamba2_block(m, _t(x), tcfg)
    assert none is None
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-4, atol=1e-4)
    js = JSm.init_mamba2_state(jcfg, 2)
    ts = {k: v[0] for k, v in TSm.init_mamba2_state(tcfg, 2).items()}
    ssm = ts["ssm"]
    for t in range(6):
        jo, js = jblock(jp, jnp.asarray(x[:, t:t + 1]), jcfg, state=js)
        to, ts2 = TSm.mamba2_block(m, _t(x[:, t:t + 1]), tcfg, state=ts)
        assert ts2 is ts and ts["ssm"] is ssm
        np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-4, atol=1e-4)
        for k in ("conv_x", "conv_bc", "ssm"):
            np.testing.assert_allclose(_np(ts[k]), _np(js[k]), rtol=1e-5,
                                       atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,chunk", [(21, 8), (64, 64), (100, 32)])
def test_wkv6_matches_reference(L, chunk):
    r, k, v, logw, u, s0 = _wkv_inputs(1, 2, L, 2, 4)
    jo, jf = JR.wkv6_chunked(*map(jnp.asarray, (r, k, v, logw, u)),
                             chunk=chunk, init_state=jnp.asarray(s0))
    to, tf = TR.wkv6_chunked(*map(_t, (r, k, v, logw, u)), chunk=chunk,
                             init_state=_t(s0))
    np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tf), _np(jf), rtol=1e-4, atol=1e-4)


def test_wkv6_chunked_matches_naive_recurrence():
    r, k, v, logw, u, _ = _wkv_inputs(1, 2, 21, 2, 4)
    o, final = TR.wkv6_chunked(*map(_t, (r, k, v, logw, u)), chunk=8)
    S = np.zeros((2, 2, 4, 4), np.float32)
    w = np.exp(logw)
    outs = []
    for t in range(21):
        bonus = np.einsum("bhd,hd,bhd,bhe->bhe", r[:, t], u, k[:, t], v[:, t])
        outs.append(np.einsum("bhd,bhde->bhe", r[:, t], S) + bonus)
        S = w[:, t, :, :, None] * S + np.einsum("bhd,bhe->bhde", k[:, t],
                                                 v[:, t])
    np.testing.assert_allclose(_np(o), np.stack(outs, 1), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(_np(final), S, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_wkv6_chunk_size_invariance(chunk):
    rng = np.random.default_rng(2)
    B, L, H, D = 1, 32, 2, 8
    rkv = [_t(rng.normal(size=(B, L, H, D))) for _ in range(3)]
    logw = _t(-rng.uniform(0.1, 1.0, size=(B, L, H, D)))
    u = _t(rng.normal(size=(H, D)))
    o1, f1 = TR.wkv6_chunked(*rkv, logw, u, chunk=chunk)
    o2, f2 = TR.wkv6_chunked(*rkv, logw, u, chunk=L)
    np.testing.assert_allclose(_np(o1), _np(o2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(f1), _np(f2), rtol=1e-4, atol=1e-4)


def test_rwkv6_mixes_match_reference():
    """The reduced rwkv6's time-mix and channel-mix on the reference's
    weights (fp32): the prefill, then 6 decode steps, each step's output
    and its shift and WKV states (written in place) as the reference's."""
    jcfg, tcfg = _cfgs("rwkv6-1.6b")
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    jtm = JR.init_rwkv6_timemix(k1, jcfg)
    jcm = JR.init_rwkv6_channelmix(k2, jcfg)
    tm, cm = TR.TimeMix(tcfg, device="cpu"), TR.ChannelMix(tcfg, device="cpu")
    _carry(tm, jtm)
    _carry(cm, jcm)
    tm, cm = tm.float(), cm.float()
    jtm, jcm = (jax.tree.map(lambda a: a.astype(jnp.float32), t)
                for t in (jtm, jcm))
    x = np.random.default_rng(7).normal(size=(2, 20, jcfg.d_model)
                                        ).astype(np.float32)
    jtime = jax.jit(JR.rwkv6_timemix, static_argnums=2)
    jchan = jax.jit(JR.rwkv6_channelmix, static_argnums=2)
    for jf, tf_, jp, tp in ((jtime, TR.rwkv6_timemix, jtm, tm),
                            (jchan, TR.rwkv6_channelmix, jcm, cm)):
        jy, _ = jf(jp, jnp.asarray(x), jcfg)
        ty, none = tf_(tp, _t(x), tcfg)
        assert none is None
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-4, atol=1e-4)
    jst = JR.init_rwkv6_state(jcfg, 2)
    tst = {k: v[0].float() if v.dtype == torch.bfloat16 else v[0]
           for k, v in TR.init_rwkv6_state(tcfg, 2).items()}
    jtm_s = {"shift": jst["tm_shift"].astype(jnp.float32), "wkv": jst["wkv"]}
    jcm_s = {"shift": jst["cm_shift"].astype(jnp.float32)}
    ttm_s = {"shift": tst["tm_shift"], "wkv": tst["wkv"]}
    tcm_s = {"shift": tst["cm_shift"]}
    for t in range(6):
        xt = x[:, t:t + 1]
        jo, jtm_s = jtime(jtm, jnp.asarray(xt), jcfg, state=jtm_s)
        to, _ = TR.rwkv6_timemix(tm, _t(xt), tcfg, state=ttm_s)
        np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-4, atol=1e-4)
        jc, jcm_s = jchan(jcm, jnp.asarray(xt), jcfg, state=jcm_s)
        tc, _ = TR.rwkv6_channelmix(cm, _t(xt), tcfg, state=tcm_s)
        np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-4, atol=1e-4)
        for got, want in ((ttm_s["shift"], jtm_s["shift"]),
                          (ttm_s["wkv"], jtm_s["wkv"]),
                          (tcm_s["shift"], jcm_s["shift"])):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-5)
    assert ttm_s["wkv"] is tst["wkv"]


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

def test_mrope_three_distinct_streams():
    """Sections summing to head_dim // 2 with three different position
    streams: the reference's angles, each channel block from its stream."""
    rng = np.random.default_rng(8)
    pos = rng.integers(0, 4000, (3, 2, 11))
    secs, hd, theta = (4, 6, 6), 32, 1e6
    got = TL.rope_angles(torch.from_numpy(pos), hd, theta, secs)
    want = JL.rope_angles(jnp.asarray(pos), hd, theta, secs)
    assert got.shape == (2, 11, hd // 2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)
    plain = [_np(TL.rope_angles(torch.from_numpy(pos[i]), hd, theta))
             for i in range(3)]
    np.testing.assert_array_equal(_np(got)[..., :4], plain[0][..., :4])
    np.testing.assert_array_equal(_np(got)[..., 4:10], plain[1][..., 4:10])
    np.testing.assert_array_equal(_np(got)[..., 10:], plain[2][..., 10:])
    x = rng.normal(size=(2, 11, 3, hd)).astype(np.float32)
    np.testing.assert_allclose(_np(TL.apply_rope(_t(x), got)),
                               _np(JL.apply_rope(jnp.asarray(x), want)),
                               rtol=1e-4, atol=1e-4)


def test_mrope_text_only_is_rope():
    """Three equal streams give plain RoPE's angles."""
    pos = np.random.default_rng(9).integers(0, 4000, (2, 7))
    same = np.broadcast_to(pos, (3, 2, 7)).copy()
    got = TL.rope_angles(torch.from_numpy(same), 32, 1e4, (4, 6, 6))
    np.testing.assert_array_equal(
        _np(got), _np(TL.rope_angles(torch.from_numpy(pos), 32, 1e4)))


def test_mrope_sections_past_half_slice_as_reference():
    """The reduced qwen2-vl: head_dim 16, half 8, sections (16, 24, 24):
    stream 0 gives all 8 channels, streams 1 and 2 none, as in the
    reference."""
    jcfg, tcfg = _cfgs("qwen2-vl-7b")
    assert tcfg.head_dim // 2 < sum(tcfg.mrope_sections)
    pos = np.random.default_rng(10).integers(0, 100, (3, 2, 5))
    got = TL.rope_angles(torch.from_numpy(pos), tcfg.head_dim, tcfg.rope_theta,
                         tcfg.mrope_sections)
    want = JL.rope_angles(jnp.asarray(pos), jcfg.head_dim, jcfg.rope_theta,
                          jcfg.mrope_sections)
    assert got.shape == want.shape == (2, 5, tcfg.head_dim // 2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        _np(got), _np(TL.rope_angles(torch.from_numpy(pos[0]), tcfg.head_dim,
                                     tcfg.rope_theta)))
