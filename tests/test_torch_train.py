"""The port's dense training path (``repro_torch.models`` loss and steps,
``layers.FlashAttention``, ``launch.train``) against the JAX reference, at
the reduced tinyllama size (2 layers, d 64, 4 query heads, head dim 16,
``attn_chunk`` 32), on the reference's weights carried by
``params_from_reference`` and the reference's token batches.

Tolerances (each measured here first):
- The attention gradient against ``jax.grad`` of the reference's chunked
  jnp attention: fp32 rtol 1e-4, atol 1e-5 (measured ~1e-6: summation
  order; the port recomputes the row softmax per query chunk where the
  reference runs the online max over key chunks); bf16 relative Frobenius
  error <= 1e-2 per input (measured ~4e-3: the reference rounds P to bf16
  inside each key tile of its online softmax, the port rounds the
  normalised P once).
- ``chunked_softmax_xent`` and ``loss_fn``, value and every gradient leaf:
  fp32 weights 1e-4 (rtol, and atol 1e-4 of the leaf's largest gradient);
  bf16 weights: loss 1e-4 relative, every leaf's gradient within 3e-2
  relative Frobenius error (measured <= 1.5e-2: bf16 products and bf16
  gradient sums round at other places in the two frameworks).
- Three steps of ``make_train_step`` (monolithic and ``microbatches=2``,
  ``AdamWConfig(lr=1e-2, warmup_steps=1)`` so that the weights move):
  fp32 weights: loss and grad norm 1e-5 relative, the parameters' distance
  to the reference's <= 1e-3 of the distance they moved (measured ~2e-5);
  bf16 weights: loss 2e-3 relative, grad norm 1e-2, distance <= 0.2 of the
  distance moved (measured ~0.11: where a bf16 gradient element differs in
  sign or size, Adam's normalised step differs by up to 2·lr).
- ``train()`` resumed from a checkpoint: bit-equal to the uninterrupted
  run, parameters and optimizer state.
"""

import dataclasses
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.data import make_token_pipeline as j_pipeline
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import steps as JS
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch import configs as TC
from repro_torch.data import make_token_pipeline
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import steps as TS
from repro_torch.models import opt_state_from_reference, params_from_reference
from repro_torch.optim import AdamWConfig, adamw_init

torch.set_num_threads(1)
k8_module = importlib.import_module("repro_torch.kernels.flash_attention")

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
SMOKE_SHAPE = JC.ShapeSpec("smoke", seq_len=32, global_batch=4, mode="train")
MOVING = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def _cfgs(**kw):
    return (dataclasses.replace(JC.reduced(JC.get_config(ARCH)), **kw),
            dataclasses.replace(TC.reduced(TC.get_config(ARCH)), **kw))


def _by_name(tree, n_layers):
    """{port parameter name: fp32 numpy} of a tree shaped like the
    reference's params (stacked layers cut per layer)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        a = np.asarray(jnp.asarray(leaf).astype(jnp.float32))
        if keys[0] == "layers":
            for i in range(n_layers):
                out[".".join(["layers", str(i)] + keys[1:])] = a[i]
        else:
            out[".".join(keys)] = a
    return out


def _carry(jp, tcfg, fp32: bool):
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return (tp.float() if fp32 else tp).requires_grad_(True)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


# ---------------------------------------------------------------------------
# The differentiable attention
# ---------------------------------------------------------------------------

def _qkv_do(B, Sq, Sk, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D), (B, Sq, H, D))]


def _grads_both(q, k, v, do, causal, dtype, chunk=32):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)

    def f(q, k, v):
        o = JL.flash_attention(q, k, v, causal=causal, chunk_q=chunk,
                               chunk_k=chunk)
        return jnp.sum(o.astype(jnp.float32) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(
        *[jnp.asarray(x).astype(jd) for x in (q, k, v)])
    tq, tk, tv = [torch.from_numpy(x).to(td).requires_grad_(True)
                  for x in (q, k, v)]
    o = TL.flash_attention(tq, tk, tv, causal=causal, chunk=chunk)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(td))
    return ([np.asarray(w.astype(jnp.float32)) for w in want],
            [g.float().numpy() for g in got], got)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hkv", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_grad_matches_reference(dtype, hkv, causal):
    """S 64 over 2 query chunks of 32, GQA 4/1 and 4/2."""
    want, got, raw = _grads_both(*_qkv_do(2, 64, 64, 4, hkv, 16, seed=hkv),
                                 causal, dtype)
    for g, w, t, name in zip(got, want, raw, "qkv"):
        assert t.dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            assert _rel(w, g) <= 1e-2, (name, _rel(w, g))


def test_attention_grad_other_shapes():
    """Sq != Sk (non-causal), a chunk that does not divide S, causal with
    Sk < Sq, and one sequence per slab: fp32 against the reference."""
    for (B, Sq, Sk, causal, chunk) in ((2, 48, 80, False, 32),
                                       (1, 50, 50, True, 16),
                                       (2, 40, 24, True, 32)):
        want, got, _ = _grads_both(*_qkv_do(B, Sq, Sk, 4, 2, 16, seed=Sq),
                                   causal, "float32", chunk=chunk)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    args = _qkv_do(3, 64, 64, 4, 2, 16, seed=5)
    _, whole, _ = _grads_both(*args, True, "float32")
    with mock.patch.object(TL, "BACKWARD_SLAB_BYTES", 1):
        _, slabbed, _ = _grads_both(*args, True, "float32")
    for a, b in zip(whole, slabbed):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_attention_backward_never_calls_the_plain_version():
    """The forward is K8 (its plain version on the CPU); the backward is
    its own: it never calls ``kernels/ref.flash_attention_ref``."""
    calls = []
    real = k8_module.flash_attention_ref

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*a, **kw)

    q, k, v, do = (torch.from_numpy(x) for x in _qkv_do(1, 64, 64, 4, 1, 16))
    q.requires_grad_(True)
    with mock.patch.object(k8_module, "flash_attention_ref", counted):
        o = TL.flash_attention(q, k, v, chunk=32)
        assert len(calls) == 1
        torch.autograd.grad(o, (q,), do)
        assert len(calls) == 1
        with torch.no_grad():
            TL.flash_attention(q, k, v)
        assert len(calls) == 2 and o.grad_fn is not None


@pytest.mark.parametrize("remat,microbatches", [(False, 1), (True, 1),
                                                (True, 2)])
def test_train_step_launch_pattern(remat, microbatches):
    """K8 (here its plain version, counted at the wrapper's call) runs
    n_layers x (2 with remat, 1 without) x microbatches times a step."""
    _, tcfg = _cfgs(remat=remat)
    params, state = TS.init_train_state(tcfg, seed=0, device="cpu")
    batch = make_token_pipeline(tcfg, SMOKE_SHAPE, seed=1).batch_at(0)
    step = TS.make_train_step(tcfg, microbatches=microbatches)
    calls = []
    real = k8_module.flash_attention_ref
    with mock.patch.object(k8_module, "flash_attention_ref",
                           lambda *a, **kw: calls.append(1) or real(*a, **kw)):
        step(params, state, batch)
    assert len(calls) == tcfg.n_layers * (1 + remat) * microbatches


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(64, 512), (100, 32)])
def test_chunked_softmax_xent_matches_reference(S, chunk):
    """Value and the gradients of h and w_out, fp32, with a loss mask and
    a chunk that does not divide S."""
    rng = np.random.default_rng(S)
    h = rng.normal(size=(3, S, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 200)) * 0.2).astype(np.float32)
    lab = rng.integers(0, 200, (3, S)).astype(np.int32)
    mask = (rng.random((3, S)) > 0.2).astype(np.float32)
    (jv, jg) = jax.value_and_grad(
        lambda h, w: JL.chunked_softmax_xent(h, w, lab, chunk=chunk,
                                             mask=mask), argnums=(0, 1))(h, w)
    th, tw = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    tv = TL.chunked_softmax_xent(th, tw, torch.from_numpy(lab), chunk=chunk,
                                 mask=torch.from_numpy(mask))
    tg = torch.autograd.grad(tv, (th, tw))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-7)
    with torch.no_grad():
        assert float(TL.chunked_softmax_xent(th, tw, torch.from_numpy(lab),
                                             chunk=chunk)) > 0


@pytest.mark.parametrize("weights", ["fp32", "bf16"])
@pytest.mark.parametrize("nkv,remat", [(4, False), (2, True)],
                         ids=["kv4", "kv2-remat"])
def test_loss_fn_value_and_grads_match_reference(weights, nkv, remat):
    jcfg, tcfg = _cfgs(n_kv_heads=nkv, remat=remat)
    jp = JM.init_params(jax.random.PRNGKey(nkv), jcfg)
    batch = j_pipeline(jcfg, SMOKE_SHAPE, seed=3).batch_at(0)
    mask = (np.arange(SMOKE_SHAPE.seq_len) % 5 != 0).astype(np.float32)
    batch["loss_mask"] = np.broadcast_to(mask, batch["tokens"].shape).copy()
    fp32 = weights == "fp32"
    jpp = jax.tree.map(lambda x: x.astype(jnp.float32), jp) if fp32 else jp
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jpp)
    tp = _carry(jp, tcfg, fp32)
    grads, tm = TS.make_grad_step(tcfg)(tp, batch)
    assert set(tm) == {"loss", "nll", "aux"} and float(tm["aux"]) == 0.0
    np.testing.assert_allclose(float(tm["loss"]), float(jl),
                               rtol=1e-6 if fp32 else 1e-4)
    want = _by_name(jg, jcfg.n_layers)
    assert set(want) == set(grads)
    for n, g in grads.items():
        assert g.dtype == dict(tp.named_parameters())[n].dtype
        w, g = want[n], g.float().numpy()
        if fp32:
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=n)
        else:
            assert _rel(w, g) <= 3e-2, (n, _rel(w, g))
    for p in tp.parameters():
        assert p.grad is None


# ---------------------------------------------------------------------------
# The slice: train steps, optimizer state carried across
# ---------------------------------------------------------------------------

def _distance(tp, jp, p0, n_layers):
    want, start = _by_name(jp, n_layers), _by_name(p0, n_layers)
    num = den = 0.0
    for n, p in tp.named_parameters():
        got = p.detach().float().numpy()
        num += float(((want[n] - got) ** 2).sum())
        den += float(((want[n] - start[n]) ** 2).sum())
    return np.sqrt(num / den)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("weights", ["fp32", "bf16"])
def test_train_steps_match_reference(weights, microbatches):
    """Three steps of ``make_train_step`` against the reference's jitted
    step from the same carried weights on the same batches."""
    jcfg, tcfg = _cfgs()
    fp32 = weights == "fp32"
    jp0 = JM.init_params(jax.random.PRNGKey(1), jcfg)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp0) if fp32 else jp0
    start = jp
    tp = _carry(jp0, tcfg, fp32)
    js, ts = j_adamw_init(jp), adamw_init(tp)
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamWConfig(**MOVING),
                                       microbatches=microbatches))
    tstep = TS.make_train_step(tcfg, AdamWConfig(**MOVING),
                               microbatches=microbatches)
    pipe = j_pipeline(jcfg, SMOKE_SHAPE, seed=3)
    for s in range(3):
        batch = pipe.batch_at(s)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp2, ts2, tm = tstep(tp, ts, batch)
        assert tp2 is tp and ts2 is ts
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if fp32 else 2e-3)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=1e-5 if fp32 else 1e-2)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert _distance(tp, jp, start, jcfg.n_layers) <= (1e-3 if fp32
                                                           else 0.2)
    assert int(ts["step"]) == int(js["step"]) == 3


def test_microbatched_step_matches_monolithic_loss():
    """The reference's own check, on the port: the same tokens give the
    same loss whether split or not."""
    _, tcfg = _cfgs()
    batch = make_token_pipeline(tcfg, SMOKE_SHAPE, seed=4).batch_at(0)
    out = []
    for m in (1, 2):
        params, opt = TS.init_train_state(tcfg, seed=1, device="cpu")
        out.append(TS.make_train_step(tcfg, microbatches=m)(
            params, opt, batch)[2])
    assert float(out[0]["loss"]) == pytest.approx(float(out[1]["loss"]),
                                                  rel=1e-5)
    assert set(out[1]) == {"grad_norm", "lr", "loss", "nll"}


def test_accumulate_grads_is_what_the_microbatched_step_applies():
    """``accumulate_grads`` is the fp32 mean of each microbatch's gradient,
    and ``make_train_step(microbatches=2)`` is it followed by the update,
    bit for bit."""
    _, tcfg = _cfgs()
    batch = make_token_pipeline(tcfg, SMOKE_SHAPE, seed=7).batch_at(1)
    pa, sa = TS.init_train_state(tcfg, seed=3, device="cpu")
    pb, sb = TS.init_train_state(tcfg, seed=3, device="cpu")
    loss, grads = TS.accumulate_grads(pb, tcfg, batch, 2)
    grad_step = TS.make_grad_step(tcfg)
    halves = [grad_step(pb, {k: v[i * 2:(i + 1) * 2] for k, v in
                             batch.items()}) for i in range(2)]
    assert float(loss) == pytest.approx((float(halves[0][1]["loss"])
                                         + float(halves[1][1]["loss"])) / 2,
                                        rel=1e-6)
    for n, g in grads.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, (halves[0][0][n].float()
                               + halves[1][0][n].float()) / 2), n
    TS.make_apply_grads(tcfg)(pb, sb, grads)
    TS.make_train_step(tcfg, microbatches=2)(pa, sa, batch)
    for (n, a), (_, b) in zip(pa.named_parameters(), pb.named_parameters()):
        assert torch.equal(a, b), n


def test_grad_step_then_apply_equals_train_step():
    """``make_grad_step`` + ``make_apply_grads`` is the monolithic step,
    bit for bit."""
    _, tcfg = _cfgs()
    batch = make_token_pipeline(tcfg, SMOKE_SHAPE, seed=6).batch_at(2)
    pa, sa = TS.init_train_state(tcfg, seed=2, device="cpu")
    pb, sb = TS.init_train_state(tcfg, seed=2, device="cpu")
    TS.make_train_step(tcfg)(pa, sa, batch)
    grads, _ = TS.make_grad_step(tcfg)(pb, batch)
    out = TS.make_apply_grads(tcfg)(pb, sb, grads)
    assert set(out) == {"grad_norm", "lr"}
    for (n, a), (_, b) in zip(pa.named_parameters(), pb.named_parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(sa["m"][n], sb["m"][n])


def test_opt_state_from_reference_carries_a_mid_run_state():
    """Two reference steps, then the reference's (params, opt_state)
    carried to the port bit for bit: the port's third step is the
    reference's third step within the bf16 bounds."""
    jcfg, tcfg = _cfgs()
    jp = JM.init_params(jax.random.PRNGKey(3), jcfg)
    js = j_adamw_init(jp)
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamWConfig(**MOVING)))
    pipe = j_pipeline(jcfg, SMOKE_SHAPE, seed=5)
    for s in range(2):
        jp, js, _ = jstep(jp, js, jax.tree.map(jnp.asarray, pipe.batch_at(s)))
    np_p, np_s = jax.tree.map(np.asarray, (jp, js))
    tp = params_from_reference(np_p, tcfg, "cpu").requires_grad_(True)
    ts = opt_state_from_reference(np_s, tp)
    assert int(ts["step"]) == 2 and ts["step"].dtype == torch.int32
    for key in ("m", "v"):
        want = _by_name(np_s[key], jcfg.n_layers)
        for n, t in ts[key].items():
            assert t.dtype == torch.float32 and np.array_equal(t.numpy(),
                                                               want[n])
    start = jp
    jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, pipe.batch_at(2)))
    _, _, tm = TS.make_train_step(tcfg, AdamWConfig(**MOVING))(
        tp, ts, pipe.batch_at(2))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-2)
    assert _distance(tp, jp, start, jcfg.n_layers) <= 0.2
    with pytest.raises(ValueError, match="without a port parameter"):
        opt_state_from_reference(dict(np_s, m=dict(np_s["m"], x=np.zeros(2))),
                                 tp)


def test_microbatched_mrope_positions_split_on_dim_1():
    """M-RoPE positions (3, B, S) are split on dim 1: each microbatch gets
    its own rows of every stream, and the microbatched gradient is the
    monolithic one (fp32)."""
    tcfg = TC.reduced(TC.get_config("qwen2-vl-7b"))
    params, _ = TS.init_train_state(tcfg, seed=0, device="cpu")
    params.float()
    batch = make_token_pipeline(tcfg, SMOKE_SHAPE).batch_at(0)
    B, S = batch["tokens"].shape
    base = np.arange(S)[None].repeat(B, 0)
    batch["positions"] = np.stack([base, base // 3, base + np.arange(B)[:, None]]
                                  ).astype(np.int32)
    parts = TS._split(batch, 2)
    assert parts[1]["positions"].shape == (3, B // 2, S)
    np.testing.assert_array_equal(parts[1]["positions"].numpy(),
                                  batch["positions"][:, B // 2:])
    loss2, g2 = TS.accumulate_grads(params, tcfg, batch, 2)
    loss1, g1 = TS.accumulate_grads(params, tcfg, batch, 1)
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
    for n in g1:
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(), rtol=1e-3,
                                   atol=1e-6, err_msg=n)


def test_trained_model_serves_as_before():
    """Gradients on: the serving steps run under inference mode and give
    the logits of the same weights with gradients off."""
    _, tcfg = _cfgs()
    served = TM.init_params(tcfg, seed=7, device="cpu")
    trained, _ = TS.init_train_state(tcfg, seed=7, device="cpu")
    tok = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 24))
    prefill = TS.make_prefill_step(tcfg)
    a = prefill(served, {"tokens": tok})
    b = prefill(trained, {"tokens": tok})
    assert b.grad_fn is None and not b.requires_grad
    assert torch.equal(a, b)
    caches = TM.init_caches(trained, tcfg, 2, 4)
    nxt, logits, _ = TS.make_decode_step(tcfg)(trained, caches, tok[:, :1], 0)
    assert logits.grad_fn is None and nxt.dtype == torch.int32


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _reduced_train(arch, steps, ckpt_dir=None, seed=0, opt_cfg=None):
    import repro_torch.launch.train as T
    cfg = TC.reduced(TC.get_config(arch))
    with mock.patch.object(T, "get_config", lambda a: cfg):
        return T.train(arch, steps=steps, ckpt_dir=ckpt_dir, save_interval=5,
                       shape=SMOKE_SHAPE, seed=seed, log_every=100,
                       opt_cfg=opt_cfg, device="cpu")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-vl-7b", "zamba2-1.2b",
                                  "rwkv6-1.6b", "llama4-scout-17b-a16e"])
def test_train_runs_every_family(arch):
    """train(arch) for each non-dense family at its reduced size: finite
    losses, parameters that moved."""
    params, history = _reduced_train(arch, steps=3)
    assert [s for s, _ in history] == [0, 2]
    assert all(np.isfinite(l) for _, l in history)
    fresh = TM.init_params(TC.reduced(TC.get_config(arch)), seed=0,
                           device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(params.parameters(),
                                                     fresh.parameters()))


def test_train_refuses_whisper_without_frames():
    """The token pipeline carries no frames, and the encoder-decoder's
    forward needs them (the reference's train cannot feed them either)."""
    with pytest.raises(ValueError, match="frontend_embeds"):
        _reduced_train("whisper-medium", steps=1)


def test_train_loss_decreases():
    """With weights that move (lr 1e-2 after one warmup step) the loss
    falls by a margin no CPU's rounding can close."""
    _, history = _reduced_train(ARCH, steps=12,
                                opt_cfg=AdamWConfig(lr=1e-2, warmup_steps=1,
                                                    total_steps=12))
    (s0, first), (s1, last) = history[0], history[-1]
    assert (s0, s1) == (0, 11)
    assert last < first - 0.3, history


def test_checkpoint_restart_is_bit_equal(tmp_path):
    """Checkpoint at step 10, resume to 13: parameters and optimizer state
    bit-equal to 13 uninterrupted steps."""
    import repro_torch.launch.train as T
    from repro_torch.checkpoint import load_checkpoint
    ckpt = str(tmp_path / "ck")
    _reduced_train("smollm-360m", steps=11, ckpt_dir=ckpt)
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_00000005",
                                        "step_00000010"]
    resumed, hist = _reduced_train("smollm-360m", steps=13, ckpt_dir=ckpt)
    assert hist[0][0] >= 11
    straight, _ = _reduced_train("smollm-360m", steps=13)
    for (n, a), (_, b) in zip(resumed.named_parameters(),
                              straight.named_parameters()):
        assert torch.equal(a, b), n
    cfg = TC.reduced(TC.get_config("smollm-360m"))
    like = T.train_tree(*TS.init_train_state(cfg, device="cpu"))
    (_, saved_state), step = load_checkpoint(ckpt, like)
    assert step == 12 and int(saved_state["step"]) == 13
    p, s = TS.init_train_state(cfg, device="cpu")
    trainer = TS.make_train_step(cfg)
    pipe = make_token_pipeline(cfg, SMOKE_SHAPE)
    for k in range(13):
        trainer(p, s, pipe.batch_at(k))
    for key in ("m", "v"):
        for n, t in s[key].items():
            assert torch.equal(t, saved_state[key][n]), (key, n)


def test_train_main_runs_and_needs_a_device(tmp_path, capsys):
    from repro_torch.launch import train as T
    assert T.main(["--arch", ARCH, "--steps", "2", "--reduced", "--device",
                   "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    assert "[train] step" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "LATEST")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.train(ARCH, steps=1, use_reduced=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.init_train_state(TC.reduced(TC.get_config(ARCH)))


def test_train_n_layers_cuts_the_depth_only():
    from repro_torch.launch import train as T
    full = TC.reduced(TC.get_config(ARCH))
    params, hist = T.train(ARCH, steps=2, use_reduced=True, device="cpu",
                           n_layers=1, log_every=1)
    assert len(params.layers) == 1 and [s for s, _ in hist] == [0, 1]
    assert params.embed.shape == (full.vocab_size, full.d_model)


# ---------------------------------------------------------------------------
# Import hygiene
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|ml_dtypes)\b|from\s+(jax|ml_dtypes)\b"
                        r"|import\s+repro(\s|\.|,|$)|from\s+repro(\s|\.))",
                        re.M)


@pytest.mark.parametrize("rel", [
    "optim/__init__.py", "optim/adamw.py", "optim/compression.py",
    "checkpoint/__init__.py", "checkpoint/store.py", "data/pipeline.py",
    "launch/train.py", "models/layers.py", "models/steps.py",
    "models/convert.py", "models/model.py", "models/transformer.py",
    "../../chip_smoke.py"])
def test_training_modules_import_no_jax(rel):
    text = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert not _FORBIDDEN.findall(text)


def test_training_packages_import_first():
    """Each new package imports in a fresh interpreter with JAX and
    ml_dtypes blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['ml_dtypes'] = None; sys.modules['repro'] = None; "
            "import repro_torch.optim, repro_torch.checkpoint, "
            "repro_torch.launch.train, repro_torch.models.steps")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
