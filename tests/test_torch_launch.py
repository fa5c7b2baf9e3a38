"""The port's launch tools (``repro_torch.launch.{mesh,sharding,specs,
dryrun}``) against the reference's ``repro.launch``, and the A1–A4
leftovers (``core/{csr,fes,svd}.py``) on the cases of
``tests/test_core_units.py``.

Sharding rules: for every arch x {train_4k, decode_32k} on both production
mesh shapes, each parameter, optimizer moment, cache and batch leaf's spec
equals the reference's (built with the fake-mesh trick of
``tests/test_train_integration.py``); a port parameter is one layer of the
reference's stacked leaf, so its spec is the reference's without the layer
dim's entry, which the reference never shards.  Specs: every stand-in's
shape and dtype equal the reference's ``eval_shape`` (a stacked leaf's
shape is the layer count before the port's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config
from repro.launch import sharding as JSH
from repro.launch import specs as JSP
from repro_torch.configs import get_config as tget_config
from repro_torch.core import collectives
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as TSH
from repro_torch.launch import specs as TSP

MESHES = {"16x16": (("data", "model"), {"data": 16, "model": 16}),
          "2x16x16": (("pod", "data", "model"),
                      {"pod": 2, "data": 16, "model": 16})}


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    m = TM.make_production_mesh(multi_pod=multi_pod)
    axes, shape = MESHES["2x16x16" if multi_pod else "16x16"]
    assert m.axis_names == axes and m.shape == shape
    assert all(d.type == "meta" for d in m.devices.flat)
    assert TM.n_devices(m) == (512 if multi_pod else 256)
    assert TM.data_axes(m) == (("pod", "data") if multi_pod else ("data",))
    assert TM.model_axis(m) == "model"


def test_host_mesh():
    m = TM.make_host_mesh("cpu")
    assert m.shape == {"data": 1, "model": 1}
    assert m.devices[0, 0] == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_host_mesh()


# ---------------------------------------------------------------------------
# the reference's rules on a fake mesh, and the port's
# ---------------------------------------------------------------------------

class _NS:
    def __init__(self, mesh, spec):
        self.spec = spec


def _fake_mesh(name):
    axes, shape = MESHES[name]
    return type("FakeMesh", (), {"axis_names": axes, "shape": shape})()


def _norm(spec, ndim):
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else
           (tuple(e) if isinstance(e, (tuple, list)) else e) for e in spec]
    return tuple(out + [None] * (ndim - len(out)))


def _flat(tree, is_leaf=None):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


def _tflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tflat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


_REF = {}


def _ref(arch):
    """The reference's eval_shape stand-ins of one arch (cached)."""
    if arch not in _REF:
        cfg = get_config(arch)
        ps = JSP.params_specs(cfg)
        _REF[arch] = (cfg, ps, JSP.opt_specs(cfg, ps),
                      JSP.cache_specs(cfg, SHAPES["decode_32k"], ps))
    return _REF[arch]


_PORT = {}


def _port(arch):
    if arch not in _PORT:
        cfg = tget_config(arch)
        model = TSP.params_specs(cfg)
        _PORT[arch] = (cfg, model, TSP.opt_specs(cfg, model),
                       TSP.cache_specs(cfg, SHAPES["decode_32k"], model))
    return _PORT[arch]


def _ref_key(name):
    return "/".join(TSH.param_path(name))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_match_reference(arch, shape_name, mesh_name, monkeypatch):
    jcfg, jps, jopt, jcache = _ref(arch)
    shape = SHAPES[shape_name]
    if not cell_is_runnable(jcfg, shape)[0]:
        pytest.skip("cell not runnable")
    monkeypatch.setattr(JSH, "NamedSharding", _NS)
    fake = _fake_mesh(mesh_name)
    mesh = TM.make_production_mesh(multi_pod=mesh_name == "2x16x16")
    tcfg, model, topt, tcache = _port(arch)
    is_ns = lambda x: isinstance(x, _NS)  # noqa: E731

    # parameters
    jp = JSH.params_shardings(jps, jcfg, fake, mode=shape.mode)
    jspec, jleaf = _flat(jp, is_ns), _flat(jps)
    tspec = TSH.params_shardings(model, tcfg, mesh, mode=shape.mode)
    tparams = dict(model.named_parameters())
    assert {_ref_key(n) for n in tparams} == set(jleaf)

    def held(jtree, jleaves, tspecs, tleaves, key_of, what):
        for n, t in tleaves.items():
            k = key_of(n)
            ref_shape = tuple(jleaves[k].shape)
            lead = len(ref_shape) - t.ndim
            assert lead in (0, 1) and ref_shape[lead:] == tuple(t.shape), \
                (what, n, ref_shape, tuple(t.shape))
            want = _norm(jtree[k].spec, len(ref_shape))
            assert want[:lead] == (None,) * lead, (what, n, want)
            assert _norm(tspecs[n], t.ndim) == want[lead:], (what, n)

    held(jspec, jleaf, tspec, tparams, _ref_key, "param")

    if shape.mode == "train":
        jo = JSH.opt_state_shardings(jopt, jp, jcfg, fake)
        to = TSH.opt_state_shardings(topt, tspec, tcfg, mesh)
        for mom in ("m", "v"):
            held(_flat(jo[mom], is_ns), _flat(jopt[mom]), to[mom], topt[mom],
                 _ref_key, f"opt {mom}")
        assert _norm(jo["step"].spec, 0) == to["step"] == ()
        jb = JSP.batch_specs(jcfg, shape)
        tb = TSP.batch_specs(tcfg, shape)
    else:
        jc = _flat(JSH.cache_shardings(jcache, jcfg, fake, shape.global_batch),
                   is_ns)
        tc = _tflat(TSH.cache_shardings(tcache, tcfg, mesh,
                                        shape.global_batch))
        assert set(jc) == set(tc)
        for k, t in _tflat(tcache).items():
            assert _norm(jc[k].spec, t.ndim) == _norm(tc[k], t.ndim), k
        jb = JSP.decode_input_specs(jcfg, shape)
        tb = TSP.decode_input_specs(tcfg, shape)
        jb, tb = {"token": jb["token"]}, {"token": tb["token"]}
    jbs = JSH.batch_shardings(jb, fake, shape.global_batch)
    tbs = TSH.batch_shardings(tb, mesh, shape.global_batch)
    for k, t in tb.items():
        assert _norm(jbs[k].spec, t.ndim) == _norm(tbs[k], t.ndim), k

    # every spec divides its dim: shard_shape takes each leaf
    for n, t in tparams.items():
        TSH.shard_shape(tuple(t.shape), tspec[n], mesh)


def _jdtype(dt):
    return str(jnp.dtype(dt))


def _tdtype(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_eval_shape(arch):
    """Parameters, AdamW moments, decode caches, both batches: the port's
    meta stand-ins have the reference's shapes and dtypes."""
    jcfg, jps, jopt, jcache = _ref(arch)
    tcfg, model, topt, tcache = _port(arch)
    jl = _flat(jps)
    for n, t in model.named_parameters():
        assert t.device.type == "meta"
        r = jl[_ref_key(n)]
        assert tuple(r.shape[len(r.shape) - t.ndim:]) == tuple(t.shape), n
        assert _jdtype(r.dtype) == _tdtype(t.dtype), n
    for mom in ("m", "v"):
        jm = _flat(jopt[mom])
        for n, t in topt[mom].items():
            assert tuple(jm[_ref_key(n)].shape[-t.ndim:]) == tuple(t.shape)
            assert t.dtype == torch.float32
    assert _jdtype(jopt["step"].dtype) == _tdtype(topt["step"].dtype)
    jc, tc = _flat(jcache), _tflat(tcache)
    assert set(jc) == set(tc)
    for k, t in tc.items():
        assert tuple(jc[k].shape) == tuple(t.shape), k
        assert _jdtype(jc[k].dtype) == _tdtype(t.dtype), k
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = SHAPES[shape_name]
        jb, tb = JSP.input_specs(jcfg, shape), TSP.input_specs(tcfg, shape)
        assert set(jb) == set(tb)
        for k, t in tb.items():
            assert tuple(jb[k].shape) == tuple(t.shape), k
            assert _jdtype(jb[k].dtype) == _tdtype(t.dtype), k


def test_shard_shape():
    mesh = TM.make_production_mesh(multi_pod=True)
    assert TSH.shard_shape((64, 1024, 512), ("model", ("pod", "data"), None),
                           mesh) == (4, 32, 512)
    assert TSH.shard_shape((7, 3), (None, None), mesh) == (7, 3)
    with pytest.raises(ValueError, match="does not divide"):
        TSH.shard_shape((24, 8), ("model", None), mesh)
    t = {"a": torch.empty((64, 32), dtype=torch.bfloat16, device="meta"),
         "b": {"c": torch.empty((512,), dtype=torch.float32, device="meta")}}
    specs = {"a": ("model", "data"), "b": {"c": (("pod", "data", "model"),)}}
    assert TSH.device_bytes(t, specs, mesh) == 4 * 2 * 2 + 1 * 4


# ---------------------------------------------------------------------------
# the ledger and the roofline terms
# ---------------------------------------------------------------------------

HLO_OPS = [  # tests/test_dryrun_tools.py's HLO_SAMPLE, op by op
    ("all-gather", (32, 128), torch.float32),
    ("all-reduce", (1024,), torch.bfloat16),
    ("reduce-scatter", (8, 128), torch.float32),
    ("all-to-all", (16, 16), torch.float32),
    ("collective-permute", (64,), torch.uint32),
    ("all-reduce", (512,), torch.float32),        # the start; its done not
]


def test_ledger_matches_collective_bytes():
    from repro.launch.dryrun import collective_bytes
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "dryrun_tools", pathlib.Path(__file__).with_name(
            "test_dryrun_tools.py"))
    tools = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools)
    with collectives.counting() as led:
        for kind, shape, dt in HLO_OPS:
            collectives.record(kind, collectives.tensor_bytes(
                torch.empty(shape, dtype=dt, device="meta")))
    assert led == collective_bytes(tools.HLO_SAMPLE)
    with pytest.raises(ValueError, match="unknown collective"):
        collectives.record("all-reduce-done", 4)


def test_roofline_terms_pick_bottleneck():
    HW = TD.HW
    acct = {"flops_per_dev": HW["peak_flops"] * 0.5,
            "bytes_per_dev": HW["hbm_bw"] * 0.1,
            "coll_bytes_per_dev": HW["ici_bw"] * 2.0}
    r = TD.roofline_terms(acct)
    assert r["bottleneck"] == "collective"
    assert r["t_compute"] == pytest.approx(0.5)
    assert r["roofline_frac"] == pytest.approx(0.25)
    # the H100's figures, not a TPU's
    assert HW["peak_flops"] == 989e12 and HW["hbm_bw"] == 3.35e12
    assert "H100" in TD.HW_LABEL and "700 W" in TD.HW_LABEL


# ---------------------------------------------------------------------------
# the dry run itself (meta tensors, no card)
# ---------------------------------------------------------------------------

def test_run_cell_olmoe_decode_collectives():
    """olmoe's decode: per layer the MoE's psum of one data shard's (B_loc,
    1, d) bf16 output and two f32 aux means, nothing else explicit; the
    arguments' bytes from the rules; the result keys."""
    r = TD.run_cell("olmoe-1b-7b", "decode_32k", verbose=False)
    cfg = tget_config("olmoe-1b-7b")
    per_layer = (128 // 16) * cfg.d_model * 2 + 8
    ex = r["accounting"]["extrapolated"]
    assert ex["coll_bytes_per_dev"] == pytest.approx(per_layer * cfg.n_layers)
    assert r["accounting"]["L1"]["coll_breakdown"] == {"all-reduce": per_layer}
    assert r["coll_scope"] == "explicit" and r["temp_is_upper_bound"]
    assert set(r["memory"]) == {"temp_bytes", "arg_bytes", "output_bytes"}
    assert r["memory"]["arg_bytes"] == TD.arg_bytes(
        cfg, SHAPES["decode_32k"], TM.make_production_mesh())
    assert ex["flops_per_dev"] > 0 and r["roofline"]["bottleneck"]
    assert r["fits"] is True


def test_run_cell_fsdp_gathers_over_data():
    """llama4-scout's decode keeps its FSDP weights split over 'data'
    (``fsdp_inference``): per layer three all-gathers of one model shard's
    experts (E_loc 1, d, ff) bf16, on both meshes (the pod mesh too, where
    the reference's gather spans ("pod", "data") and fails)."""
    cfg = tget_config("llama4-scout-17b-a16e")
    for multi_pod in (False, True):
        r = TD.run_cell("llama4-scout-17b-a16e", "decode_32k",
                        multi_pod=multi_pod, verbose=False)
        br = r["accounting"]["L1"]["coll_breakdown"]
        assert br["all-gather"] == 3 * cfg.d_model * cfg.d_ff * 2


@pytest.mark.parametrize("gather", ["naive", "shardwise"])
def test_run_anns(gather):
    """The pod search step: argument bytes per device from the placements;
    the stage-②③ hooks' all-reduces (stage ② and one stage-③ round)
    move (B, E, d) rows naive and (B, E) distances shardwise."""
    from repro_torch.core.distributed import PodIndexSpec
    r = TD.run_anns(gather=gather, verbose=False)
    s = PodIndexSpec()
    B, E, R = s.query_batch, s.ef_pilot, s.R
    width = s.d * 4 if gather == "naive" else 4
    want = B * E * width + B * R * 4 + B * R * width
    assert r["accounting"]["extrapolated"]["coll_bytes_per_dev"] == want
    assert r["memory"]["arg_bytes"] > s.pilot_bytes()


def test_cli_json(tmp_path):
    out = tmp_path / "r.json"
    assert TD.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                    "--json", str(out)]) == 0
    import json
    (r,) = json.loads(out.read_text())
    assert r["arch"] == "smollm-360m" and "roofline" in r


# ---------------------------------------------------------------------------
# A1–A4 leftovers: tests/test_core_units.py's cases against the port
# ---------------------------------------------------------------------------

def _toy_graph(n=200, R=8, seed=0):
    from repro_torch.core import graph_build as GB
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return GB.build_graph(x, R, method="exact"), x


def test_graph_valid_and_connected():
    from repro_torch.core import csr
    from repro_torch.core import graph_build as GB
    g, x = _toy_graph()
    csr.validate_graph(g)
    assert g.sentinel == g.n
    assert GB.bfs_reachable(g.neighbors, g.n, GB.medoid(x)).all()


def test_zero_outdegree_subgraph_properties():
    from repro_torch.core import csr
    g, _ = _toy_graph()
    keep = csr.subgraph_sample(g, 0.4, seed=1)
    sub = csr.zero_outdegree_subgraph(g, keep)
    csr.validate_graph(sub)
    assert sub.n == g.n
    deg = sub.out_degrees()
    assert (deg[~keep] == 0).all()
    real = sub.neighbors[sub.neighbors < sub.n]
    assert keep[real].all()


@pytest.mark.parametrize("method", ["seed_expand", "uniform"])
@pytest.mark.parametrize("ratio,seed", [(0.1, 0), (0.4, 7), (0.9, 1000)])
def test_subgraph_sample_matches_reference(method, ratio, seed):
    from repro.core import csr as jcsr
    from repro_torch.core import csr
    g, _ = _toy_graph(seed=3)
    keep = csr.subgraph_sample(g, ratio, seed=seed, method=method)
    assert abs(keep.mean() - ratio) < 0.02
    want = jcsr.subgraph_sample(jcsr.Graph(g.neighbors, g.n), ratio,
                                seed=seed, method=method)
    np.testing.assert_array_equal(keep, want)


def test_csr_roundtrip_and_from_lists():
    from repro.core import csr as jcsr
    from repro_torch.core import csr
    g, _ = _toy_graph()
    indptr, indices = g.to_csr()
    assert indptr[-1] == len(indices)
    np.testing.assert_array_equal(np.diff(indptr), g.out_degrees())
    jp, ji = jcsr.Graph(g.neighbors, g.n).to_csr()
    np.testing.assert_array_equal(indptr, jp)
    np.testing.assert_array_equal(indices, ji)
    lists = [[1, 2, 3], [], [0], list(range(3, 20))]
    a, b = csr.Graph.from_lists(lists, 20, 8), jcsr.Graph.from_lists(lists, 20, 8)
    np.testing.assert_array_equal(a.neighbors, b.neighbors)
    bad = csr.Graph(np.array([[0, 2]], np.int32), 1)
    with pytest.raises(AssertionError):
        csr.validate_graph(bad)


def test_fes_bruteforce_reverts_to_global_topk():
    """Table 2: with 1 block FES == brute force over all entries; the
    port's ids and distances equal the reference's."""
    from repro.core.fes import fes_select_bruteforce as jbrute
    from repro_torch.core.fes import build_fes, fes_select_bruteforce
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1000, 8)).astype(np.float32)
    idx = build_fes(x, np.arange(1000), r=4, n_entry=256, align=32, seed=0)
    q = rng.normal(size=(8, 8)).astype(np.float32)
    ids, d = fes_select_bruteforce(torch.from_numpy(q),
                                   torch.from_numpy(idx.entries),
                                   torch.from_numpy(idx.entry_ids),
                                   torch.from_numpy(idx.valid), 4)
    flat_ids = idx.entry_ids[idx.valid]
    dd = ((q[:, None] - x[flat_ids][None]) ** 2).sum(-1)
    expect = flat_ids[np.argsort(dd, axis=1)[:, :4]]
    assert (np.sort(ids.numpy(), 1) == np.sort(expect, 1)).all()
    jids, jd = jbrute(jnp.asarray(q), jnp.asarray(idx.entries),
                      jnp.asarray(idx.entry_ids), jnp.asarray(idx.valid), 4)
    np.testing.assert_array_equal(np.sort(ids.numpy(), 1),
                                  np.sort(np.asarray(jids), 1))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


def test_svd_split():
    from repro.core.svd import svd_fit as jfit
    from repro_torch.core.svd import svd_fit
    x = np.random.default_rng(0).normal(size=(500, 24)).astype(np.float32)
    red = svd_fit(x, 0.5)
    xp, xr = red.split(x[:10])
    assert xp.shape == (10, red.d_primary) and xr.shape == (10, 24 - red.d_primary)
    np.testing.assert_array_equal(np.concatenate([xp, xr], 1), red.rotate(x[:10]))
    q = x[10:12]
    qp, qr = red.split(q)
    d2 = ((x[:10, None] - q[None]) ** 2).sum(-1)
    np.testing.assert_allclose(
        ((xp[:, None] - qp[None]) ** 2).sum(-1)
        + ((xr[:, None] - qr[None]) ** 2).sum(-1), d2, rtol=1e-4, atol=1e-4)
    jp, jr = jfit(x, 0.5).split(x[:10])
    np.testing.assert_allclose(np.abs(xp), np.abs(jp), rtol=1e-4, atol=1e-4)
