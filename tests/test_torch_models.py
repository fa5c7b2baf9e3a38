"""The port's dense LM (``repro_torch.models``) against the JAX reference
(``repro.models``), on the reference's own weights carried over by
``params_from_reference``, at the reduced tinyllama size and with GQA
(``n_kv_heads`` 4, 2 and 1 of 4 query heads).

Tolerances:
- fp32 weights on both sides: 1e-4 (summation order only).  The KV cache
  is bf16 whatever the weights are (as in the reference), so a value whose
  fp32 forms straddle a bf16 rounding boundary lands one bf16 ulp apart;
  decode is therefore compared step by step from the reference's caches.
- bf16 weights: the two frameworks round bf16 products at other places,
  and the reference's attention rounds P to bf16 where the port's (K8)
  keeps it fp32: relative error <= 2e-2 and top-1 agreement >= 0.95, the
  flips only at near-tied logits."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import steps as JS
from repro_torch import configs as TC
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import steps as TS
from repro_torch.models import params_from_reference

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
B, S = 4, 64
F32 = dict(rtol=1e-4, atol=1e-4)
ULP_BF16 = 2.0 ** -7          # bf16 spacing relative to the value


def _cfgs(nkv):
    j = dataclasses.replace(JC.reduced(JC.get_config(ARCH)), n_kv_heads=nkv)
    t = dataclasses.replace(TC.reduced(TC.get_config(ARCH)), n_kv_heads=nkv)
    return j, t


@pytest.fixture(scope="module", params=[4, 2, 1], ids=lambda n: f"kv{n}")
def setup(request):
    """Reference weights (bf16) and their carried copy, both also cast to
    fp32, with seeded tokens."""
    jcfg, tcfg = _cfgs(request.param)
    jp = JM.init_params(jax.random.PRNGKey(request.param), jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    tp32 = params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                 "cpu").float()
    tok = np.random.default_rng(request.param).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jp32=jp32, tp32=tp32,
                tok=tok)


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _layer0(s, fp32=True):
    jp, tp = (s["jp32"], s["tp32"]) if fp32 else (s["jp"], s["tp"])
    return jax.tree.map(lambda x: x[0], jp["layers"]), tp.layers[0]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_configs_are_the_reference_s(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    assert j.active_param_count() == t.active_param_count()
    assert dataclasses.asdict(JC.reduced(j)) == dataclasses.asdict(TC.reduced(t))
    assert list(JC.SHAPES) == list(TC.SHAPES)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_params_from_reference_is_bit_exact(setup):
    """Every leaf crosses with its dtype and bits, the layer stack unstacked;
    bf16 also as uint16 bit patterns."""
    jp, tp = setup["jp"], setup["tp"]
    names = dict(tp.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    n_leaves = 0
    for path, leaf in flat:
        keys = [p.key for p in path]
        arr = np.asarray(leaf)
        if keys[0] == "layers":
            for i in range(arr.shape[0]):
                got = names[".".join(["layers", str(i)] + keys[1:])]
                assert str(got.dtype).endswith(arr.dtype.name)
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy() if arr.dtype.name == "bfloat16"
                    else got.numpy(),
                    arr[i].view(np.int16) if arr.dtype.name == "bfloat16"
                    else arr[i])
                n_leaves += 1
        else:
            got = names[".".join(keys)]
            want = arr.view(np.int16) if arr.dtype.name == "bfloat16" else arr
            have = (got.view(torch.int16) if got.dtype == torch.bfloat16
                    else got).numpy()
            np.testing.assert_array_equal(have, want)
            n_leaves += 1
    assert n_leaves == len(names)
    bits = jax.tree.map(lambda x: np.asarray(x).view(np.uint16)
                        if x.dtype == jnp.bfloat16 else np.asarray(x), jp)
    again = params_from_reference(bits, setup["tcfg"], "cpu")
    for (n, a), (_, b) in zip(tp.named_parameters(), again.named_parameters()):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), n


def test_params_from_reference_refuses_a_wrong_tree(setup):
    tree = jax.tree.map(np.asarray, setup["jp"])
    with pytest.raises(ValueError, match="without a port parameter"):
        params_from_reference(dict(tree, extra=np.zeros(3, np.float32)),
                              setup["tcfg"], "cpu")
    short = dataclasses.replace(setup["tcfg"], n_layers=1)
    with pytest.raises(ValueError, match="layers stacked"):
        params_from_reference(tree, short, "cpu")


def test_init_params_scales_and_device_rule():
    """The port's own init: the reference's shapes, dtypes and scales, one
    seed one model; no card means no default device."""
    _, tcfg = _cfgs(2)
    a = TM.init_params(tcfg, seed=3, device="cpu")
    b = TM.init_params(tcfg, seed=3, device="cpu")
    jshapes = jax.eval_shape(lambda k: JM.init_params(k, _cfgs(2)[0]),
                             jax.random.PRNGKey(0))
    assert a.embed.shape == jshapes["embed"].shape
    assert a.lm_head.shape == jshapes["lm_head"].shape
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
        assert not x.requires_grad
    assert abs(float(a.embed.float().std()) - 0.02) < 2e-3
    w = a.layers[0].mlp.wd.w
    assert w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05
    assert a.final_ln.w.dtype == torch.float32 and bool((a.final_ln.w == 1).all())
    assert sum(p.numel() for p in a.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_params(tcfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_reference(jax.tree.map(np.asarray, JM.init_params(
                jax.random.PRNGKey(0), _cfgs(2)[0])), tcfg)


# ---------------------------------------------------------------------------
# layer functions (fp32 weights)
# ---------------------------------------------------------------------------

def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    np.testing.assert_allclose(_np(TL.rms_norm(tx, tw)),
                               _np(JL.rms_norm(x, w)), **F32)
    np.testing.assert_allclose(_np(TL.layer_norm(tx, tw, tb)),
                               _np(JL.layer_norm(x, w, b)), **F32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = TL.rms_norm(tx.to(torch.bfloat16), tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(JL.rms_norm(xb, w)),
                               rtol=ULP_BF16, atol=1e-6)
    norm = TL.Norm(64, "layernorm", device="cpu")
    norm.w.copy_(tw), norm.b.copy_(tb)
    np.testing.assert_allclose(
        _np(TL.apply_norm(norm, tx, "layernorm")),
        _np(JL.apply_norm({"w": w, "b": b}, x, "layernorm")), **F32)


def test_linear_with_bias_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    lin = TL.Linear(32, 48, bias=True, dtype=torch.float32, device="cpu")
    lin.w.copy_(torch.from_numpy(w)), lin.b.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(_np(TL.linear(lin, torch.from_numpy(x))),
                               _np(JL.linear({"w": w, "b": b}, x)), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 5000, (2, 9))
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    ang_t = TL.rope_angles(torch.from_numpy(pos), 16, 1e4)
    ang_j = JL.rope_angles(jnp.asarray(pos), 16, 1e4)
    np.testing.assert_allclose(_np(ang_t), _np(ang_j), rtol=1e-6, atol=0)
    tdt = getattr(torch, dtype)
    got = TL.apply_rope(torch.from_numpy(x).to(tdt), ang_t)
    want = JL.apply_rope(jnp.asarray(x).astype(getattr(jnp, dtype)), ang_j)
    assert got.dtype == tdt
    tol = dict(rtol=ULP_BF16, atol=1e-2) if dtype == "bfloat16" else F32
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # M-RoPE sections with (B, S) positions: plain RoPE, as the reference
    np.testing.assert_allclose(
        _np(TL.rope_angles(torch.from_numpy(pos), 16, 1e4, (2, 3, 3))),
        _np(JL.rope_angles(jnp.asarray(pos), 16, 1e4, (2, 3, 3))),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    jp = JL.init_mlp(jax.random.PRNGKey(0), 32, 64, act, dtype=jnp.float32)
    mod = TL.MLP(32, 64, act, dtype=torch.float32, device="cpu")
    for name, leaf in jp.items():
        getattr(mod, name).w.copy_(torch.from_numpy(np.array(leaf["w"])))
    np.testing.assert_allclose(_np(TL.mlp(mod, torch.from_numpy(x), act)),
                               _np(JL.mlp(jp, x, act)), **F32)


def test_attention_block_matches_reference(setup):
    """attention_qkv (projections, GQA reshape, rope) and attention (K8's
    plain version on the CPU) on layer 0's fp32 weights."""
    jl, tl = _layer0(setup)
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    x = np.random.default_rng(4).normal(size=(2, 40, jcfg.d_model)
                                        ).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    ja = JL.rope_angles(jnp.asarray(pos), jcfg.head_dim, jcfg.rope_theta)
    ta = TL.rope_angles(torch.from_numpy(pos.copy()), tcfg.head_dim,
                        tcfg.rope_theta)
    tx = torch.from_numpy(x)
    for got, want in zip(TL.attention_qkv(tl.attn, tx, tcfg, ta),
                         JL.attention_qkv(jl["attn"], x, jcfg, ja)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(TL.attention(tl.attn, tx, tcfg, angles=ta)),
                               _np(JL.attention(jl["attn"], x, jcfg, angles=ja)),
                               **F32)


def test_cache_update_and_decode_attention_match_reference(setup):
    """bf16 caches: the new K/V is rounded to bf16, and so are the
    probabilities before P·V."""
    jcfg = setup["jcfg"]
    H, Hkv, D = jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    rng = np.random.default_rng(5)
    cache = rng.normal(size=(2, 12, Hkv, D)).astype(np.float32)
    new = rng.normal(size=(2, 1, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(2, 1, H, D)).astype(np.float32)
    jc = jnp.asarray(cache).astype(jnp.bfloat16)
    tc = torch.from_numpy(cache).to(torch.bfloat16)
    jc2 = JL.cache_update(jc, jnp.asarray(new), jnp.int32(7))
    tc2 = TL.cache_update(tc, torch.from_numpy(new), 7)
    assert tc2.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tc2), _np(jc2))
    for pos in (0, 7, 11):
        got = TL.decode_attention(torch.from_numpy(q), tc2, tc2 * 0.5, pos)
        want = JL.decode_attention(jnp.asarray(q), jc2, jc2 * 0.5,
                                   jnp.int32(pos))
        np.testing.assert_allclose(_np(got), _np(want), **F32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_and_unembed_fp32_match_reference(setup):
    jh, _ = JM.forward(setup["jp32"], setup["jcfg"], jnp.asarray(setup["tok"]))
    th, aux = TM.forward(setup["tp32"], setup["tcfg"], setup["tok"])
    assert th.shape == (B, S, setup["tcfg"].d_model) and float(aux) == 0.0
    np.testing.assert_allclose(_np(th), _np(jh), **F32)
    np.testing.assert_allclose(_np(TM.unembed(setup["tp32"], setup["tcfg"], th)),
                               _np(JM.unembed(setup["jp32"], setup["jcfg"], jh)),
                               **F32)


def test_decode_step_fp32_matches_reference(setup):
    """Each step from the reference's caches: logits within 1e-4; the new
    cache entries, rounded to bf16 on both sides, within one bf16 ulp (a
    near-boundary value rounds the other way) and every other entry
    unchanged."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    steps = 12
    jstep = jax.jit(JM.decode_step, static_argnums=1)
    jc = JM.init_caches(setup["jp32"], jcfg, B, steps + 1)
    flips = total = 0
    for t in range(steps):
        tc = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy()
                                  ).view(torch.bfloat16) for k, v in jc.items()}
        before = {k: v.clone() for k, v in tc.items()}
        tok = setup["tok"][:, t:t + 1]
        jl, jc = jstep(setup["jp32"], jcfg, jnp.asarray(tok), jc, jnp.int32(t))
        tl, tc = TM.decode_step(setup["tp32"], tcfg, tok, tc, t)
        assert tl.shape == (B, 1, tcfg.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(_np(tl), _np(jl), **F32)
        for k in ("k", "v"):
            got, want = _np(tc[k]), _np(jc[k])
            others = np.ones(got.shape[2], bool)
            others[t] = False
            np.testing.assert_array_equal(got[:, :, others],
                                          _np(before[k])[:, :, others])
            np.testing.assert_allclose(got[:, :, t], want[:, :, t],
                                       rtol=ULP_BF16, atol=0)
            flips += int((got[:, :, t] != want[:, :, t]).sum())
            total += got[:, :, t].size
    assert flips <= 0.01 * total


def test_bf16_forward_and_decode_match_reference(setup):
    """bf16 weights: hidden state within 2e-2 relative; logits' top-1
    agrees on >= 0.95 of the rows, the others near-ties."""
    jcfg, tcfg, tok = setup["jcfg"], setup["tcfg"], setup["tok"]
    jh, _ = JM.forward(setup["jp"], jcfg, jnp.asarray(tok))
    th, _ = TM.forward(setup["tp"], tcfg, tok)
    assert th.dtype == torch.bfloat16
    a, b = _np(jh), _np(th)
    assert np.abs(a - b).mean() / np.abs(a).mean() <= 2e-2
    jl = _np(JM.unembed(setup["jp"], jcfg, jh))
    tl = _np(TM.unembed(setup["tp"], tcfg, th))
    _top1(jl, tl)

    steps = 16
    jstep = jax.jit(JM.decode_step, static_argnums=1)
    jc = JM.init_caches(setup["jp"], jcfg, B, steps)
    tc = TM.init_caches(setup["tp"], tcfg, B, steps)
    jls, tls = [], []
    for t in range(steps):
        x, jc = jstep(setup["jp"], jcfg, jnp.asarray(tok[:, t:t + 1]), jc,
                      jnp.int32(t))
        y, tc = TM.decode_step(setup["tp"], tcfg, tok[:, t:t + 1], tc, t)
        jls.append(_np(x)[:, 0]), tls.append(_np(y)[:, 0])
    jls, tls = np.stack(jls, 1), np.stack(tls, 1)
    assert np.abs(jls - tls).mean() / np.abs(jls).mean() <= 2e-2
    _top1(jls, tls)
    for k in ("k", "v"):
        a, b = _np(jc[k]), _np(tc[k])
        assert np.abs(a - b).mean() / np.abs(a).mean() <= 2e-2


def _top1(want, got, bar=0.95, near=1e-2):
    agree = want.argmax(-1) == got.argmax(-1)
    assert agree.mean() >= bar, f"top-1 agreement {agree.mean():.4f}"
    top2 = np.sort(want, -1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    assert (margin[~agree] <= near).all(), margin[~agree]


def test_port_prefill_matches_its_decode(setup):
    """The port's own teacher-forced decode against its full-sequence
    forward (bf16, the reference's bars: top-1 >= 0.95, rel < 0.15)."""
    tcfg, tp, tok = setup["tcfg"], setup["tp"], setup["tok"][:, :32]
    h, _ = TM.forward(tp, tcfg, tok)
    full = _np(TM.unembed(tp, tcfg, h))
    caches = TM.init_caches(tp, tcfg, B, tok.shape[1] + 1)
    step = []
    for t in range(tok.shape[1]):
        lg, caches = TM.decode_step(tp, tcfg, tok[:, t:t + 1], caches, t)
        step.append(_np(lg)[:, 0])
    step = np.stack(step, 1)
    assert (full.argmax(-1) == step.argmax(-1)).mean() >= 0.95
    assert np.abs(full - step).mean() / (np.abs(full).mean() + 1e-6) < 0.15


def test_serving_steps_match_reference(setup):
    jcfg, tcfg, tok = setup["jcfg"], setup["tcfg"], setup["tok"][:, :16]
    want = JS.make_prefill_step(jcfg)(setup["jp32"], {"tokens": jnp.asarray(tok)})
    got = TS.make_prefill_step(tcfg)(setup["tp32"], {"tokens": tok})
    assert got.shape == (B, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    jc = JM.init_caches(setup["jp32"], jcfg, B, 4)
    tc = TM.init_caches(setup["tp32"], tcfg, B, 4)
    jn, jl, _ = JS.make_decode_step(jcfg)(setup["jp32"], jc,
                                          jnp.asarray(tok[:, :1]), jnp.int32(0))
    tn, tl, _ = TS.make_decode_step(tcfg)(setup["tp32"], tc, tok[:, :1], 0)
    assert tn.dtype == torch.int32 and tn.shape == (B, 1)
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
