"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe.moe_ffn``, on the reference's weights, at the
``reduced()`` olmoe (E 4, top-2) and llama4-scout (top-1, a shared expert)
sizes and on hand-made configs with top-4 of 8 experts.

What is compared, on the tokens whose reference top-k margin (the gap
between the k-th and the (k+1)-th router probability, and between any two
of the top k) exceeds 1e-5, where a rounding cannot change the routing:
- routing: each token's experts and which of its pairs were kept;
- fp32 outputs within 1e-5, the aux loss within 1e-6, gradients within
  1e-4 relative of ``jax.grad`` (absolute 1e-5 of the largest gradient
  entry);
- bf16: the combine is bit-equal to the reference's scatter-add on the
  same expert outputs (the order claim: XLA applies the updates in slot
  order, so a token sums its experts' outputs in ascending expert id,
  rounding after each add).  The whole bf16 FFN is held within two bf16
  ulps of the output's scale: XLA's CPU logistic in bf16 rounds after each
  step (exp, 1 +, 1 /) where ``F.silu`` rounds once, and the CPU products
  sum in another order."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from repro import configs as JC
from repro.models import moe as JMo
from repro_torch import configs as TC
from repro_torch.models import moe as TMo
from repro_torch.models.convert import _tensor

torch.set_num_threads(1)


def _cfgs(arch="olmoe-1b-7b", **kw):
    j = dataclasses.replace(JC.reduced(JC.get_config(arch)), **kw)
    t = dataclasses.replace(TC.reduced(TC.get_config(arch)), **kw)
    return j, t


def _carry(jp, tcfg, dtype=torch.bfloat16) -> TMo.MoE:
    """The port's MoE module holding the reference's ``init_moe`` leaves
    (cast to ``dtype`` for float32 runs)."""
    m = TMo.MoE(tcfg, device="cpu")
    with torch.no_grad():
        for n in ("router", "wg", "wu", "wd"):
            getattr(m, n).copy_(_tensor(np.asarray(jp[n])))
        if "shared" in jp:
            for n, leaf in jp["shared"].items():
                getattr(m.shared, n).w.copy_(_tensor(np.asarray(leaf["w"])))
    return m.float() if dtype == torch.float32 else m


def _setup(T, dtype="bfloat16", seed=0, arch="olmoe-1b-7b", **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = JMo.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).normal(
        size=(2, T // 2, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tdt = getattr(torch, dtype)
    m = _carry(jp, tcfg, tdt)
    tx = _tensor(np.asarray(jx)).to(tdt)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        jx = jx.astype(jnp.float32)
    return jcfg, tcfg, jp, m, jx, tx


def _ref_routing(jp, jx, jcfg):
    """The reference's routing and dispatch lines (``moe.py:57-86``):
    (probs, top_e, the kept slot of each (token, j) pair or E·C, safe_idx,
    gate_w)."""
    B, S, d = jx.shape
    E, k, T = jcfg.n_experts, jcfg.top_k, B * S
    C = JMo._capacity(T, k, E, jcfg.capacity_factor)
    xf = jx.reshape(T, d)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], axis=-1)
    top_p, top_e = lax.top_k(probs, k)
    top_p = top_p / jnp.maximum(jnp.sum(top_p, axis=-1, keepdims=True), 1e-9)
    pe = top_e.reshape(-1)
    pt = jnp.repeat(jnp.arange(T, dtype=jnp.int32), k)
    pg = top_p.reshape(-1)
    order = jnp.argsort(pe, stable=True)
    se, st, sg = pe[order], pt[order], pg[order]
    counts = jnp.sum(jax.nn.one_hot(pe, E, dtype=jnp.int32), axis=0)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k, dtype=jnp.int32) - starts[se]
    keep = rank < C
    slot = jnp.where(keep, se * C + rank, E * C)
    tok_idx = jnp.full((E * C + 1,), T, jnp.int32).at[slot].set(
        jnp.where(keep, st, T))[: E * C]
    gate_w = jnp.zeros((E * C + 1,), jnp.float32).at[slot].set(
        jnp.where(keep, sg, 0.0))[: E * C]
    pair_slot = jnp.zeros((T * k,), jnp.int32).at[order].set(slot)
    safe_idx = jnp.where(tok_idx < T, tok_idx, 0)
    return (np.asarray(probs), np.asarray(top_e),
            np.asarray(pair_slot).reshape(T, k), safe_idx, gate_w)


def _clear(probs: np.ndarray, k: int) -> np.ndarray:
    """Tokens whose top-k (and the k-th against the next) are separated by
    more than 1e-5."""
    ps = -np.sort(-probs, axis=-1)[:, :k + 1]
    return np.min(ps[:, :-1] - ps[:, 1:], axis=-1) > 1e-5


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("T", [8, 64, 1000, 4096, 4097])
@pytest.mark.parametrize("k,E,factor", [(2, 4, 1.25), (8, 64, 1.25),
                                        (1, 16, 1.0), (2, 4, 0.25)])
def test_capacity_matches_reference(T, k, E, factor):
    assert TMo._capacity(T, k, E, factor) == JMo._capacity(T, k, E, factor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,kw", [(64, {}), (512, {"capacity_factor": 0.25}),
                                  (256, {"top_k": 4, "n_experts": 8})],
                         ids=["olmoe", "drops", "top4of8"])
def test_routing_matches_reference(dtype, T, kw):
    """Experts, and which pairs are kept and where, equal on the clear
    tokens; at capacity factor 0.25 the capacity binds and pairs drop."""
    jcfg, tcfg, jp, m, jx, tx = _setup(T, dtype, **kw)
    probs, top_e, pair_slot, _, _ = _ref_routing(jp, jx, jcfg)
    k = jcfg.top_k
    C = TMo._capacity(T, k, jcfg.n_experts, jcfg.capacity_factor)
    _, _, t_e, token_slots, perm, slot_token, slot_j = TMo.route(
        tx.reshape(T, -1).float() @ m.router, k, C)
    ok = _clear(probs, k)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(t_e.numpy()[ok], top_e[ok])
    # the port's slots, back in top-k order, against the reference's
    by_pair = torch.empty_like(token_slots).scatter_(1, perm, token_slots)
    np.testing.assert_array_equal(by_pair.numpy()[ok], pair_slot[ok])
    dropped = int((pair_slot == jcfg.n_experts * C).sum())
    if kw.get("capacity_factor"):
        assert dropped > 0
        assert int((token_slots == jcfg.n_experts * C).sum()) == dropped
    # the inverse map: each occupied slot names its token and column
    occ = slot_token < T
    s = torch.arange(jcfg.n_experts * C)[occ]
    assert torch.equal(token_slots[slot_token[occ], slot_j[occ]], s)
    assert int(occ.sum()) == T * k - dropped


@pytest.mark.parametrize("T,kw", [(64, {}), (512, {"capacity_factor": 0.25}),
                                  (256, {"top_k": 4, "n_experts": 8})],
                         ids=["olmoe", "drops", "top4of8"])
def test_moe_ffn_fp32_matches_reference(T, kw):
    jcfg, tcfg, jp, m, jx, tx = _setup(T, "float32", **kw)
    jy, jaux = JMo.moe_ffn(jp, jx, jcfg)
    ty, taux = TMo.moe_ffn(m, tx, tcfg)
    ok = _clear(_ref_routing(jp, jx, jcfg)[0], jcfg.top_k)
    np.testing.assert_allclose(_np(ty).reshape(T, -1)[ok],
                               _np(jy).reshape(T, -1)[ok], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


def test_shared_expert_matches_reference():
    """llama4-scout: top-1 of the routed experts plus the shared MLP."""
    jcfg, tcfg, jp, m, jx, tx = _setup(64, "float32",
                                       arch="llama4-scout-17b-a16e")
    assert hasattr(m, "shared") and "shared" in jp
    jy, jaux = JMo.moe_ffn(jp, jx, jcfg)
    ty, taux = TMo.moe_ffn(m, tx, tcfg)
    ok = _clear(_ref_routing(jp, jx, jcfg)[0], jcfg.top_k)
    np.testing.assert_allclose(_np(ty).reshape(64, -1)[ok],
                               _np(jy).reshape(64, -1)[ok], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("T,kw", [(64, {}), (256, {"top_k": 4, "n_experts": 8}),
                                  (128, {"top_k": 8, "n_experts": 16})],
                         ids=["top2", "top4of8", "top8of16"])
def test_bf16_combine_is_the_reference_scatter(T, kw):
    """On the same bf16 expert outputs and gates, ``_Combine`` equals the
    reference's ``zeros.at[safe_idx].add(ye * gate_w)`` bit for bit."""
    jcfg, tcfg, jp, m, jx, tx = _setup(T, "bfloat16", **kw)
    _, _, _, safe_idx, gate_w = _ref_routing(jp, jx, jcfg)
    k, E = jcfg.top_k, jcfg.n_experts
    C = TMo._capacity(T, k, E, jcfg.capacity_factor)
    d = jcfg.d_model
    ye = np.random.default_rng(7).normal(size=(E * C, d)).astype(np.float32)
    jye = jnp.asarray(ye).astype(jnp.bfloat16)
    want = jnp.zeros((T, d), jnp.bfloat16).at[safe_idx].add(
        jye * gate_w[:, None].astype(jnp.bfloat16))
    _, top_p, _, token_slots, perm, slot_token, slot_j = TMo.route(
        tx.reshape(T, -1).float() @ m.router, k, C)
    got = TMo._Combine.apply(_tensor(np.asarray(jye)), top_p.gather(1, perm),
                             token_slots, slot_token, slot_j)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_bf16_moe_ffn_near_reference():
    """The whole bf16 FFN: on the clear tokens within two bf16 ulps of the
    output's largest magnitude (a quarter of one on average), the aux
    loss within 1e-6."""
    jcfg, tcfg, jp, m, jx, tx = _setup(256, "bfloat16", top_k=4, n_experts=8)
    jy, jaux = JMo.moe_ffn(jp, jx, jcfg)
    ty, taux = TMo.moe_ffn(m, tx, tcfg)
    assert ty.dtype == torch.bfloat16
    ok = _clear(_ref_routing(jp, jx, jcfg)[0], jcfg.top_k)
    a, b = _np(jy).reshape(256, -1)[ok], _np(ty).reshape(256, -1)[ok]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)
    assert np.abs(a - b).max() <= 2 * ulp
    assert np.abs(a - b).mean() <= 0.25 * ulp, np.abs(a - b).mean() / ulp
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch,T,kw", [
    ("olmoe-1b-7b", 64, {}),
    ("olmoe-1b-7b", 512, {"capacity_factor": 0.25}),
    ("llama4-scout-17b-a16e", 64, {})], ids=["olmoe", "drops", "shared"])
def test_moe_gradient_matches_jax_grad(arch, T, kw):
    """fp32 gradients of sum(y · r) + aux with respect to the input, the
    router and every expert weight, against ``jax.grad``."""
    jcfg, tcfg, jp, m, jx, tx = _setup(T, "float32", arch=arch, **kw)
    r = np.random.default_rng(9).normal(size=jx.shape).astype(np.float32)
    # a token at a routing near-tie flips between the two sides; drop the
    # sample unless every token is clear
    assert _clear(_ref_routing(jp, jx, jcfg)[0], jcfg.top_k).all()

    def jloss(p, x):
        y, aux = JMo.moe_ffn(p, x, jcfg)
        return jnp.sum(y * r) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    m.requires_grad_(True)
    tx = tx.clone().requires_grad_(True)
    y, aux = TMo.moe_ffn(m, tx, tcfg)
    (y * torch.from_numpy(r)).sum().add(aux).backward()
    want = {"x": np.asarray(jgx), "router": jgp["router"], "wg": jgp["wg"],
            "wu": jgp["wu"], "wd": jgp["wd"]}
    got = {"x": tx.grad, "router": m.router.grad, "wg": m.wg.grad,
           "wu": m.wu.grad, "wd": m.wd.grad}
    if "shared" in jp:
        for n in jp["shared"]:
            want[f"shared.{n}"] = jgp["shared"][n]["w"]
            got[f"shared.{n}"] = getattr(m.shared, n).w.grad
    # relative to the largest entry of all the gradients: with top-1 the
    # renormalised gate is 1 and the router's gradient is the aux loss's
    # plus rounding noise of the output term's scale on both sides
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(_np(got[n]), np.asarray(w), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=n)


def test_dispatch_and_combine_backward_are_gathers():
    """The custom backwards against autograd through plain indexing (which
    accumulates with ``index_put_``): equal in fp32 up to rounding, and a
    replayed backward is bit-equal."""
    jcfg, tcfg, jp, m, jx, tx = _setup(512, "float32", capacity_factor=0.25)
    T, d = 512, jcfg.d_model
    k, E = jcfg.top_k, jcfg.n_experts
    C = TMo._capacity(T, k, E, jcfg.capacity_factor)
    _, top_p, _, token_slots, perm, slot_token, slot_j = TMo.route(
        tx.reshape(T, -1) @ m.router, k, C)
    gates = top_p.gather(1, perm)
    xf = tx.reshape(T, d)
    rng = np.random.default_rng(3)
    dxe = torch.from_numpy(rng.normal(size=(E * C, d)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    ye = torch.from_numpy(rng.normal(size=(E * C, d)).astype(np.float32))

    def grads(custom: bool):
        x = xf.clone().requires_grad_(True)
        y_in = ye.clone().requires_grad_(True)
        g_in = gates.clone().requires_grad_(True)
        if custom:
            xe = TMo._Dispatch.apply(x, slot_token, token_slots)
            y = TMo._Combine.apply(y_in, g_in, token_slots, slot_token, slot_j)
        else:
            xe = TMo._zero_row(x)[slot_token]
            pad = TMo._zero_row(y_in)
            y = sum(pad[token_slots[:, j]] * g_in[:, j:j + 1]
                    for j in range(k))
        torch.autograd.backward((xe, y), (dxe, dy))
        return x.grad, y_in.grad, g_in.grad

    a, b, c = grads(True), grads(True), grads(False)
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v)
        np.testing.assert_allclose(u.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)
