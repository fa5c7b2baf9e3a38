"""The port's mesh-sharded MoE (``repro_torch.models.moe_sharded``) against
the reference's ``shard_map`` MoE (``repro.models.moe_sharded``).

The reference needs 8 devices, so all of its runs go in one subprocess
with ``--xla_force_host_platform_device_count=8`` (as
``tests/test_moe_sharded.py`` does); it writes its weights, inputs,
outputs, gradients and the collective bytes of its compiled HLO to an npz
file.  The port runs the same cases in-process on a ``PodMesh`` of CPU
devices, with the weights carried across.

Held, on the tokens whose routing margin exceeds 1e-5 (``test_torch_moe``'s
rule): each data shard's slot table and dropped pairs exactly; ``y`` within
2 bf16 ulps (XLA's CPU bf16 logistic, ``test_torch_moe``); ``aux`` within
1e-6 relative; the fp32 gradient within ``test_torch_moe``'s bars of
``jax.grad`` through the shard_map.  The port is bit-equal to its own
``moe_ffn`` on a (1, 1) mesh and, at top-2, shard by shard on (2, 4); on
(pod 2, data 2, model 2) bit-equal to (data 4, model 2), where the
reference raises (its FSDP gather spans ("pod", "data"), the weights are
split over "data" alone; ROADMAP Queue C).  The collective ledger equals
the reference's HLO per kind in fp32; in bf16 XLA's CPU backend carries the
all-reduce and all-gathers in f32 (a widening the port does not need: it
moves bf16), which the test names."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from repro import configs as JC
from repro_torch import configs as TC
from repro_torch.core import collectives
from repro_torch.core.distributed import PodMesh
from repro_torch.models import moe as TMo
from repro_torch.models import moe_sharded as TMS
from repro_torch.models.convert import _tensor

torch.set_num_threads(1)

# name: (arch, config overrides, B, S, mesh shape, mesh axes)
CASES = {
    "olmoe": ("olmoe-1b-7b", {}, 4, 16, (2, 4), ("data", "model")),
    "drops": ("olmoe-1b-7b", {"capacity_factor": 0.25}, 4, 128, (2, 4),
              ("data", "model")),
    "llama4": ("llama4-scout-17b-a16e", {"fsdp": True}, 4, 16, (2, 4),
               ("data", "model")),
    "replicated": ("olmoe-1b-7b", {}, 3, 16, (2, 4), ("data", "model")),
    "pod": ("llama4-scout-17b-a16e", {"fsdp": True}, 4, 16, (2, 2, 2),
            ("pod", "data", "model")),
}
GRAD_CASES = ("olmoe", "llama4")

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced
from repro.launch.dryrun import collective_bytes
from repro.launch.mesh import _auto_axis_kwargs
from repro.models import moe_sharded
from repro.models.moe import init_moe, moe_ffn

CASES, GRAD_CASES, out_path = eval(sys.argv[1]), eval(sys.argv[2]), sys.argv[3]
out = {}

def put(prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            put(f"{prefix}/{k}", v)
        else:
            a = np.asarray(v)
            out[f"{prefix}/{k}"] = (a.view(np.uint16)
                                    if str(a.dtype) == "bfloat16" else a)

def f32(t):
    return jax.tree.map(lambda a: a.astype(jnp.float32), t)

for name, (arch, kw, B, S, shape, axes) in CASES.items():
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    mesh = jax.make_mesh(shape, axes, **_auto_axis_kwargs(len(axes)))
    da = tuple(a for a in ("pod", "data") if a in axes)
    p = init_moe(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    put(f"{name}/p", p)
    put(name, {"x": x})
    moe_sharded.set_moe_mesh(mesh, da)
    try:
        with mesh:
            f = jax.jit(lambda p, x: moe_ffn(p, x, cfg))
            y, aux = f(p, x)
            coll = collective_bytes(f.lower(p, x).compile().as_text())
            coll32 = collective_bytes(
                f.lower(f32(p), x.astype(jnp.float32)).compile().as_text())
            if name in GRAD_CASES:
                r = rng.normal(size=x.shape).astype(np.float32)
                def loss(p, x):
                    y, aux = moe_ffn(p, x, cfg)
                    return jnp.sum(y * r) + aux
                gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                    f32(p), x.astype(jnp.float32))
                put(f"{name}/grad", {"x": gx, "r": r, "p": gp})
        put(name, {"y": y, "aux": aux})
        for k, v in coll.items():
            out[f"{name}/coll_bf16/{k}"] = np.asarray(v)
        for k, v in coll32.items():
            out[f"{name}/coll_f32/{k}"] = np.asarray(v)
    except ValueError as e:
        out[f"{name}/error"] = np.asarray(str(e))
    moe_sharded.set_moe_mesh(None, ())
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_sharded") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "src")))
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, "-c", SCRIPT, repr(CASES),
                           repr(GRAD_CASES), str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tree(ref, prefix):
    """The nested dict of the npz keys under ``prefix/``."""
    out = {}
    for k, v in ref.items():
        if k.startswith(prefix + "/"):
            *path, leaf = k[len(prefix) + 1:].split("/")
            d = out
            for part in path:
                d = d.setdefault(part, {})
            d[leaf] = v
    return out


def _cfgs(name):
    arch, kw = CASES[name][:2]
    return (dataclasses.replace(JC.reduced(JC.get_config(arch)), **kw),
            dataclasses.replace(TC.reduced(TC.get_config(arch)), **kw))


def _carry(p, tcfg) -> TMo.MoE:
    m = TMo.MoE(tcfg, device="cpu")
    with torch.no_grad():
        for n in ("router", "wg", "wu", "wd"):
            getattr(m, n).copy_(_tensor(p[n]))
        if "shared" in p:
            for n, leaf in p["shared"].items():
                getattr(m.shared, n).w.copy_(_tensor(leaf["w"]))
    return m


def _mesh(shape, axes):
    return PodMesh(np.full(shape, "cpu", dtype=object), axes)


def _run(m, x, cfg, shape, axes):
    """The port's sharded MoE on a CPU mesh -> (y, aux, ledger)."""
    da = tuple(a for a in ("pod", "data") if a in axes)
    TMS.set_moe_mesh(_mesh(shape, axes), da)
    try:
        with collectives.counting() as led:
            y, aux = TMo.moe_ffn(m, x, cfg)
    finally:
        TMS.set_moe_mesh(None, ())
    return y, aux, led


def _setup(ref, name):
    jcfg, tcfg = _cfgs(name)
    p = _tree(ref, f"{name}/p")
    return jcfg, tcfg, p, _carry(p, tcfg), _tensor(ref[f"{name}/x"])


def _np(t):
    return t.detach().float().numpy()


def _shards(name):
    B, S, shape, axes = CASES[name][2:]
    n = int(np.prod([s for s, a in zip(shape, axes) if a != "model"]))
    return (n, B // n) if B % n == 0 else (1, B)


def _ref_shard_routing(p, xb, jcfg, C):
    """The reference body's routing lines (``moe_sharded.py:69-95``) on one
    data shard's tokens: (probs, top_e, the kept slot of each (token, j)
    pair or E·C)."""
    Bl, S, d = xb.shape
    E, k, T = jcfg.n_experts, jcfg.top_k, Bl * S
    xf = jnp.asarray(xb).reshape(T, d)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_e = lax.top_k(probs, k)
    pe = top_e.reshape(-1)
    order = jnp.argsort(pe, stable=True)
    se = pe[order]
    counts = jnp.sum(jax.nn.one_hot(pe, E, dtype=jnp.int32), axis=0)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k, dtype=jnp.int32) - starts[se]
    slot = jnp.where(rank < C, se * C + rank, E * C)
    pair_slot = jnp.zeros((T * k,), jnp.int32).at[order].set(slot)
    return (np.asarray(probs), np.asarray(top_e),
            np.asarray(pair_slot).reshape(T, k))


def _clear(probs, k):
    ps = -np.sort(-probs, axis=-1)[:, :k + 1]
    return np.min(ps[:, :-1] - ps[:, 1:], axis=-1) > 1e-5


def _ref_clear(ref, name, p, jcfg):
    """The clear tokens of every data shard, in batch order."""
    x = ref[f"{name}/x"].view(jnp.bfloat16)
    n, Bl = _shards(name)
    S = x.shape[1]
    C = TMS._capacity(Bl * S, jcfg.top_k, jcfg.n_experts,
                      jcfg.capacity_factor)
    return np.concatenate([
        _clear(_ref_shard_routing(p, x[i * Bl:(i + 1) * Bl], jcfg, C)[0],
               jcfg.top_k) for i in range(n)])


@pytest.mark.parametrize("name", ["olmoe", "drops", "llama4", "replicated"])
def test_slots_and_drops_match_reference(ref, name):
    """Each data shard's experts and kept slots (capacity from its own
    T_loc) equal the reference body's on the clear tokens; with capacity
    factor 0.25 pairs drop, the same ones."""
    jcfg, tcfg, p, m, x = _setup(ref, name)
    n, Bl = _shards(name)
    S, k, E = x.shape[1], jcfg.top_k, jcfg.n_experts
    C = TMS._capacity(Bl * S, k, E, jcfg.capacity_factor)
    xj = ref[f"{name}/x"].view(jnp.bfloat16)
    drops = 0
    for i in range(n):
        probs, top_e, pair_slot = _ref_shard_routing(
            p, xj[i * Bl:(i + 1) * Bl], jcfg, C)
        xf = x[i * Bl:(i + 1) * Bl].reshape(Bl * S, -1)
        _, _, t_e, token_slots, perm, _, _ = TMo.route(
            xf.float() @ m.router, k, C)
        ok = _clear(probs, k)
        assert ok.mean() > 0.9
        np.testing.assert_array_equal(t_e.numpy()[ok], top_e[ok])
        by_pair = torch.empty_like(token_slots).scatter_(1, perm, token_slots)
        np.testing.assert_array_equal(by_pair.numpy()[ok], pair_slot[ok])
        assert int((by_pair == E * C).sum()) == int((pair_slot == E * C).sum())
        drops += int((pair_slot == E * C).sum())
    assert (drops > 0) == (name == "drops")


@pytest.mark.parametrize("name", ["olmoe", "drops", "llama4", "replicated"])
def test_output_and_aux_match_reference(ref, name):
    """y within two bf16 ulps of the output's largest magnitude on the
    clear tokens; aux within 1e-6 relative."""
    jcfg, tcfg, p, m, x = _setup(ref, name)
    shape, axes = CASES[name][4:]
    y, aux, _ = _run(m, x, tcfg, shape, axes)
    want = _tensor(ref[f"{name}/y"]).float().numpy()
    ok = _ref_clear(ref, name, p, jcfg)
    T = x.shape[0] * x.shape[1]
    a, b = want.reshape(T, -1)[ok], _np(y).reshape(T, -1)[ok]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)
    assert y.dtype == torch.bfloat16
    assert np.abs(a - b).max() <= 2 * ulp
    np.testing.assert_allclose(float(aux), float(ref[f"{name}/aux"]),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradient_matches_jax_grad(ref, name):
    """fp32 gradients of sum(y · r) + aux with respect to the input, the
    router and every expert weight (and the shared expert's), against
    ``jax.grad`` through the reference's shard_map: within 1e-4 relative,
    absolute 1e-5 of the largest gradient entry (``test_torch_moe``'s
    bars).  A second backward is bit-equal (no atomics)."""
    jcfg, tcfg, p, m, x = _setup(ref, name)
    assert _ref_clear(ref, name, p, jcfg).all()
    shape, axes = CASES[name][4:]
    g = _tree(ref, f"{name}/grad")
    m = m.float().requires_grad_(True)

    def grads():
        m.zero_grad(set_to_none=True)
        tx = x.float().clone().requires_grad_(True)
        y, aux, _ = _run(m, tx, tcfg, shape, axes)
        (y * torch.from_numpy(g["r"])).sum().add(aux).backward()
        out = {"x": tx.grad, **{n: getattr(m, n).grad
                                for n in ("router", "wg", "wu", "wd")}}
        if hasattr(m, "shared"):
            for n in g["p"]["shared"]:
                out[f"shared.{n}"] = getattr(m.shared, n).w.grad
        return {k: v.clone() for k, v in out.items()}

    got, again = grads(), grads()
    want = {"x": g["x"], **{n: g["p"][n] for n in ("router", "wg", "wu", "wd")}}
    for n in g["p"].get("shared", {}):
        want[f"shared.{n}"] = g["p"]["shared"][n]["w"]
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(_np(got[n]), w, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=n)
        assert torch.equal(got[n], again[n]), n


@pytest.mark.parametrize("name", ["olmoe", "llama4"])
def test_one_by_one_mesh_is_moe_ffn(ref, name):
    """On a (1, 1) mesh the sharded FFN is the port's ``moe_ffn``, bit for
    bit (y and aux)."""
    _, tcfg, _, m, x = _setup(ref, name)
    y, aux, _ = _run(m, x, tcfg, (1, 1), ("data", "model"))
    y0, aux0 = TMo.moe_ffn(m, x, tcfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


@pytest.mark.parametrize("name", ["olmoe", "drops"])
def test_top2_is_moe_ffn_shard_by_shard(ref, name):
    """At top-2 the sharded output equals ``moe_ffn`` run on each data
    shard's tokens, bit for bit: a token's two slots sum in ascending
    expert id either way, and a sum of two cannot change with the order of
    the model shards' partials."""
    _, tcfg, _, m, x = _setup(ref, name)
    assert tcfg.top_k == 2
    shape, axes = CASES[name][4:]
    y, _, _ = _run(m, x, tcfg, shape, axes)
    n, Bl = _shards(name)
    want = torch.cat([TMo.moe_ffn(m, x[i * Bl:(i + 1) * Bl], tcfg)[0]
                      for i in range(n)])
    assert torch.equal(y, want)


def test_pod_mesh_repaired(ref):
    """The reference raises on (pod 2, data 2, model 2) with FSDP weights;
    the port runs, bit-equal to (data 4, model 2) (the same data shards,
    the same experts per model shard), its gradient too."""
    assert "does not match" in str(ref["pod/error"])
    _, tcfg, _, m, x = _setup(ref, "pod")
    assert tcfg.fsdp
    y_pod, aux_pod, led_pod = _run(m, x, tcfg, (2, 2, 2),
                                   ("pod", "data", "model"))
    y_d4, aux_d4, led_d4 = _run(m, x, tcfg, (4, 2), ("data", "model"))
    assert torch.equal(y_pod, y_d4) and torch.equal(aux_pod, aux_d4)
    # the pod mesh gathers over its 2 data slices, (4, 2) over 4: same
    # gathered bytes
    assert led_pod == led_d4

    m = m.float().requires_grad_(True)
    gs = []
    for shape, axes in (((2, 2, 2), ("pod", "data", "model")),
                        ((4, 2), ("data", "model"))):
        m.zero_grad(set_to_none=True)
        y, aux, _ = _run(m, x.float(), tcfg, shape, axes)
        (y.square().sum() + aux).backward()
        gs.append([q.grad.clone() for q in m.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*gs))


@pytest.mark.parametrize("name", ["olmoe", "llama4", "replicated"])
def test_ledger_matches_reference_hlo(ref, name):
    """The ledger's bytes per kind equal ``collective_bytes`` of the
    reference's compiled HLO: exactly in fp32 (the psum of y fused with the
    model mean of aux into one tuple all-reduce there, two records here: the
    same bytes), and in bf16 up to XLA's CPU widening of the bf16 all-reduce
    of y and of the FSDP all-gathers to f32 (an op the port does not need:
    it moves bf16, half the bytes)."""
    _, tcfg, _, m, x = _setup(ref, name)
    shape, axes = CASES[name][4:]
    coll = _tree(ref, f"{name}/coll_f32")
    _, _, led = _run(m.float(), x.float(), tcfg, shape, axes)
    assert {k: int(v) for k, v in coll.items()} == led

    _, tcfg, _, m, x = _setup(ref, name)
    coll = {k: int(v) for k, v in _tree(ref, f"{name}/coll_bf16").items()}
    y, _, led = _run(m, x, tcfg, shape, axes)
    aux_bytes = 4 * 2                                  # two f32 scalars
    widened = {"all-reduce": 2 * (led["all-reduce"] - aux_bytes) + aux_bytes,
               "all-gather": 2 * led.get("all-gather", 0)}
    assert coll.get("all-gather", 0) == widened["all-gather"]
    assert coll["all-reduce"] == widened["all-reduce"]
    assert led["all-reduce"] - aux_bytes == collectives.tensor_bytes(
        y[:_shards(name)[1]])
