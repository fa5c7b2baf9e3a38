"""The port's training substrate against the JAX reference: checkpoints
(``repro_torch.checkpoint``), the token pipeline (``repro_torch.data``),
AdamW and int8 gradient compression (``repro_torch.optim``).  The cases of
``tests/test_substrate.py`` for these modules, run against the port, plus
parity with the reference on the same inputs.

Tolerances:
- ``TokenPipeline.batch_at``, ``compress_int8``, ``decompress_int8``,
  ``ef_compress_tree``: bit-equal (the same numpy and IEEE operations).
- Checkpoints: the port's files and manifest leaves equal the reference's
  for the same numpy tree, and each side reads the other's bit for bit.
- ``adamw_update``, one step from identical bf16 params, bf16 grads and
  fp32 state (measured here, stated as it holds):
  * the clip does not bind: params bit-equal; ``m``/``v`` within 1e-6 of
    each leaf's largest magnitude, not bit-equal: XLA's CPU backend
    contracts ``b1·m + (1 − b1)·g`` into one fused multiply-add (a numpy
    emulation of that FMA matches the reference on every element), where
    the port rounds both products as the jnp expression is written; and
    XLA turns ``step / warmup_steps`` into a product by the reciprocal,
    so ``lr`` may differ in its last fp32 bit.
  * the clip binds: the global norm's sum order differs (fp32, ~1e-7
    relative), so the scale may differ in its last bit and a clipped bf16
    gradient by one bf16 ulp; params within one bf16 ulp, ``m``/``v``
    within 1e-6 where the clipped gradients are equal and within
    (1 − b)·(one bf16 ulp of g) where they are not.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import checkpoint as JCK
from repro import optim as JO
from repro.data import TokenPipeline as JTokenPipeline
from repro.optim.compression import ef_compress_tree as j_ef
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.data import TokenPipeline, make_token_pipeline
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, compress_int8,
                               compressed_psum_spec, decompress_int8)
from repro_torch.optim.compression import ef_compress_tree

BF16_ULP = 2.0 ** -7


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _from_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    restored, step = load_checkpoint(str(tmp_path), t)
    assert step == 3
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert restored["b"]["d"].dtype == torch.int32
    for a, b in ((t["a"], restored["a"]), (t["b"]["c"], restored["b"]["c"]),
                 (t["b"]["d"], restored["b"]["d"])):
        assert torch.equal(a, b)


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    entries = os.listdir(tmp_path)
    assert not any(e.startswith(".tmp") for e in entries)
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_manager_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, save_interval=1)
    for s in range(1, 6):
        mgr.maybe_save(s, _tree())
    steps = sorted(e for e in os.listdir(tmp_path) if e.startswith("step_"))
    assert len(steps) == 2 and steps[-1] == "step_00000005"


def test_checkpoint_restore_or_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_or_none(_tree()) is None
    mgr.maybe_save(4, _tree(), force=True)
    out = mgr.restore_or_none(_tree())
    assert out is not None and out[1] == 4


def test_checkpoint_tuples_and_device(tmp_path):
    """A ``(params, opt_state)`` tuple round-trips, each leaf on the asked
    device, tuples kept as tuples."""
    p = {"layers.0.w": torch.randn(4, 3).to(torch.bfloat16)}
    tree = (p, adamw_init(p))
    save_checkpoint(str(tmp_path), 9, tree, meta={"arch": "x"})
    back, step = load_checkpoint(str(tmp_path), tree, device="cpu")
    assert step == 9 and isinstance(back, tuple)
    assert back[0]["layers.0.w"].device.type == "cpu"
    assert torch.equal(back[0]["layers.0.w"].view(torch.int16),
                       p["layers.0.w"].view(torch.int16))
    assert back[1]["step"].dtype == torch.int32
    with open(tmp_path / "step_00000009" / "MANIFEST.json") as f:
        man = json.load(f)
    assert man["meta"] == {"arch": "x"}
    assert set(man["leaves"]) == {"0/layers.0.w", "1/m/layers.0.w",
                                  "1/v/layers.0.w", "1/step"}


def _np_state_tree():
    """(params, opt_state) of the reference's AdamW on a small numpy tree:
    bf16 and fp32 leaves, a nested dict and an int32 scalar."""
    rng = np.random.default_rng(4)
    params = {"embed": jnp.asarray(rng.normal(size=(6, 4)), jnp.bfloat16),
              "layers": {"w": jnp.asarray(rng.normal(size=(2, 4, 4)),
                                          jnp.bfloat16),
                         "ln": jnp.asarray(rng.normal(size=(2, 4)),
                                           jnp.float32)}}
    state = JO.adamw_init(params)
    grads = jax.tree.map(lambda p: p * 0.5, params)
    params, state, _ = JO.adamw_update(JO.AdamWConfig(), params, grads, state)
    return jax.tree.map(np.asarray, (params, state))


def test_checkpoint_format_matches_reference(tmp_path):
    """The same numpy tree written by the reference's ``save_checkpoint``
    and by the port's gives identical leaf files and manifest leaves; each
    side's ``load_checkpoint`` reads the other's checkpoint bit for bit."""
    tree = _np_state_tree()
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    JCK.save_checkpoint(jdir, 5, tree, meta={"arch": "t"})
    save_checkpoint(tdir, 5, tree, meta={"arch": "t"})
    mans = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "step_00000005", "MANIFEST.json")) as f:
            mans.append(json.load(f))
    assert mans[0]["leaves"] == mans[1]["leaves"]
    assert list(mans[0]["leaves"]) == list(mans[1]["leaves"])
    assert (mans[0]["step"], mans[0]["meta"]) == (mans[1]["step"],
                                                  mans[1]["meta"])
    for info in mans[0]["leaves"].values():
        a = np.load(os.path.join(jdir, "step_00000005", info["file"]))
        b = np.load(os.path.join(tdir, "step_00000005", info["file"]))
        assert a.dtype == b.dtype and np.array_equal(a, b), info
    assert open(os.path.join(jdir, "LATEST")).read() == \
        open(os.path.join(tdir, "LATEST")).read()

    want = {k: np.asarray(v).view(np.uint16) if v.dtype.name == "bfloat16"
            else np.asarray(v)
            for k, v in JCK.store._leaf_files(tree).items()}
    port_read, _ = load_checkpoint(jdir, tree)
    for k, t in JCK.store._leaf_files(port_read).items():
        got = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
        assert got.dtype == want[k].dtype and np.array_equal(got, want[k]), k
    ref_read, _ = JCK.load_checkpoint(tdir, tree)
    for k, a in JCK.store._leaf_files(ref_read).items():
        a = np.asarray(a)
        got = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert np.array_equal(got, want[k]), k


# ---------------------------------------------------------------------------
# Data pipeline: purity + host sharding, bit-equal to the reference
# ---------------------------------------------------------------------------

def test_pipeline_pure_in_seed_step():
    p = TokenPipeline(vocab_size=1000, seq_len=32, global_batch=8, seed=5)
    a = p.batch_at(7)
    b = p.batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = p.batch_at(8)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_pipeline_hosts_disjoint_and_labels_shifted():
    ps = [TokenPipeline(1000, 32, 8, n_hosts=4, host_id=h) for h in range(4)]
    batches = [p.batch_at(0) for p in ps]
    assert all(b["tokens"].shape == (2, 32) for b in batches)
    assert not np.array_equal(batches[0]["tokens"], batches[1]["tokens"])
    b = batches[0]
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    with pytest.raises(ValueError, match="split"):
        TokenPipeline(1000, 32, 8, n_hosts=3).host_batch


@pytest.mark.parametrize("vocab,seq,batch,hosts,host,seed", [
    (256, 32, 4, 1, 0, 3), (32000, 4096, 2, 1, 0, 0),
    (1000, 64, 8, 4, 2, 11)])
def test_pipeline_bit_equal_to_reference(vocab, seq, batch, hosts, host, seed):
    j = JTokenPipeline(vocab, seq, batch, n_hosts=hosts, host_id=host,
                       seed=seed)
    t = TokenPipeline(vocab, seq, batch, n_hosts=hosts, host_id=host,
                      seed=seed)
    for step in (0, 1, 17):
        a, b = j.batch_at(step), t.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    from repro_torch.configs import SHAPES, get_config
    p = make_token_pipeline(get_config("tinyllama-1.1b"), SHAPES["train_4k"],
                            seed=seed)
    assert (p.vocab_size, p.seq_len, p.global_batch) == (32000, 4096, 256)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def test_adamw_reduces_quadratic_loss():
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.5
    assert int(state["step"]) == 60 and state["step"].dtype == torch.int32


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    got = float(torch.linalg.vector_norm(clipped["a"]))
    assert got == pytest.approx(1.0, rel=1e-3)
    gb = {"a": torch.full((4,), 10.0).to(torch.bfloat16)}
    assert clip_by_global_norm(gb, 1.0)[0]["a"].dtype == torch.bfloat16


def test_adamw_refuses_mismatched_grads():
    params = {"w": torch.zeros(3)}
    with pytest.raises(ValueError, match="do not match"):
        adamw_update(AdamWConfig(), params, {"x": torch.zeros(3)},
                     adamw_init(params))


def _adam_inputs(seed: int, grad_scale: float, step: int):
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 48), "b": (300,), "c": (7, 5, 3)}
    p = {k: (rng.normal(size=s) * 0.5).astype(jnp.bfloat16)
         for k, s in shapes.items()}
    g = {k: (rng.normal(size=s) * grad_scale).astype(jnp.bfloat16)
         for k, s in shapes.items()}
    m = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (rng.random(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    return p, g, {"m": m, "v": v, "step": np.int32(step)}


@pytest.mark.parametrize("clip", ["free", "binding"])
@pytest.mark.parametrize("cfg_kw,step", [
    ({}, 0), ({}, 57), (dict(lr=4e-4, warmup_steps=1, total_steps=8), 3),
    (dict(lr=1e-2, warmup_steps=3, total_steps=20), 9)])
def test_adamw_update_matches_reference(clip, cfg_kw, step):
    """One ``adamw_update`` from identical numpy params, grads and state;
    the bounds of the module docstring."""
    grad_clip, gscale = (1e9, 1.0) if clip == "free" else (1.0, 10.0)
    p, g, st = _adam_inputs(step * 7 + len(cfg_kw), gscale, step)
    jcfg = JO.AdamWConfig(grad_clip=grad_clip, **cfg_kw)
    jp, js, jm = jax.jit(lambda p, g, s: JO.adamw_update(jcfg, p, g, s))(
        {k: jnp.asarray(x) for k, x in p.items()},
        {k: jnp.asarray(x) for k, x in g.items()},
        jax.tree.map(jnp.asarray, st))
    tp = {k: _from_bf16(x) for k, x in p.items()}
    tg = {k: _from_bf16(x) for k, x in g.items()}
    ts = {"m": {k: torch.from_numpy(x.copy()) for k, x in st["m"].items()},
          "v": {k: torch.from_numpy(x.copy()) for k, x in st["v"].items()},
          "step": torch.tensor(step, dtype=torch.int32)}
    tm = adamw_update(AdamWConfig(grad_clip=grad_clip, **cfg_kw), tp, tg, ts)
    assert int(ts["step"]) == int(js["step"]) == step + 1
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=2.5e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    tclip, _ = clip_by_global_norm(tg, grad_clip)
    jclip, _ = JO.clip_by_global_norm({k: jnp.asarray(x) for k, x in g.items()},
                                      grad_clip)
    for k in p:
        want = np.asarray(jp[k]).view(np.int16).astype(np.int32)
        got = _bits(tp[k]).astype(np.int32)
        if clip == "free":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_less(np.abs(got - want), 2)
        same_g = _bits(tclip[k]) == np.asarray(jclip[k]).view(np.int16)
        assert same_g.all() or clip == "binding"
        gmax = np.abs(np.asarray(jclip[k], np.float32))
        for key, b in (("m", 0.9), ("v", 0.95)):
            x, y = np.asarray(js[key][k]), ts[key][k].numpy()
            top = np.abs(x).max()
            assert (np.abs(x - y)[same_g] <= 1e-6 * top).all(), key
            slack = (1 - b) * BF16_ULP * (gmax if key == "m"
                                          else 2 * gmax * gmax)
            assert (np.abs(x - y) <= 1e-6 * top + slack).all(), key


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def test_int8_compression_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, s = compress_int8(g)
    deq = decompress_int8(q, s)
    assert q.dtype == torch.int8
    assert float((deq - g).abs().max()) <= float(s) * 0.5 + 1e-6
    assert compressed_psum_spec(g) == 256 + 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_compression_bit_equal_to_reference(dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 257)) * 3).astype(np.float32)
    x[0, :5] = [0.5, -0.5, 1.5, 2.5, 0.0]     # halfway cases: round to even
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = JO.compress_int8(jx)
    tq, ts = compress_int8(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.asarray(js).tobytes() == ts.numpy().tobytes()
    np.testing.assert_array_equal(decompress_int8(tq, ts).numpy(),
                                  np.asarray(JO.decompress_int8(jq, js)))
    zq, zs = compress_int8(torch.zeros(8))
    assert float(zs) == pytest.approx(1e-12 / 127.0) and not zq.any()


def test_error_feedback_accumulates():
    g = {"w": torch.tensor([0.001, 0.002, 1.0])}
    e = {"w": torch.zeros(3)}
    total = torch.zeros(3)
    for _ in range(50):
        q, s, e = ef_compress_tree(g, e)
        total = total + decompress_int8(q["w"], s["w"])
    avg = total.numpy() / 50
    np.testing.assert_allclose(avg, g["w"].numpy(), rtol=0.2, atol=5e-4)


def test_ef_compress_tree_bit_equal_to_reference():
    """Nested trees, 20 rounds of feedback: every q, scale and carried
    error equal to the reference's bits."""
    rng = np.random.default_rng(2)
    shapes = {"a": (17,), "b": {"c": (4, 9), "d": (3,)}}

    def draw(s):
        return {k: draw(v) for k, v in s.items()} if isinstance(s, dict) \
            else rng.normal(size=s).astype(np.float32) * 0.01

    def to_t(t):
        return {k: to_t(v) for k, v in t.items()} if isinstance(t, dict) \
            else torch.from_numpy(np.asarray(t).copy())

    je = jax.tree.map(lambda x: jnp.zeros_like(x), draw(shapes))
    te = to_t(je)
    for _ in range(20):
        g = draw(shapes)
        jq, js, je = j_ef(jax.tree.map(jnp.asarray, g), je)
        tq, ts, te = ef_compress_tree(to_t(g), te)
        for a, b in zip(jax.tree.leaves((jq, js, je)),
                        jax.tree.leaves(jax.tree.map(
                            lambda t: t.numpy(), (tq, ts, te)))):
            assert np.asarray(a).tobytes() == b.tobytes()
