"""PyTorch port vs the JAX reference: quantized pilot payloads.

Encodings (bytes equal to the reference's), the plain versions of the
traversal and FES kernels on bf16/int8/int4/pq tables against the
reference's Pallas kernels in interpret mode, ``search`` on the reference's
``built_index`` state for all five pilot dtypes, the ``ResidencyPlanner``
and ``set_pilot_dtype``.  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import copy
import dataclasses
from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ResidencyPlanner as JPlanner
from repro.core import SearchParams as JSearchParams
from repro.core import fes as JF
from repro.core import quant as JQ
from repro.kernels.fes_kernel import fes_distances as j_fes_distances
from repro.kernels.traversal_kernel import (fused_pilot_search as j_pilot,
                                            fused_traversal_hop as j_hop)
from repro_torch.core import (IndexConfig, PilotANNIndex, ResidencyPlan,
                              ResidencyPlanner, SearchParams)
from repro_torch.core import bloom as TB
from repro_torch.core import fes as TF
from repro_torch.core import quant as TQ
from repro_torch.kernels import fes_kernel, ops, ref as TR, traversal_kernel

torch.set_num_threads(1)

DTYPES = ("float32", "bfloat16", "int8", "int4", "pq")
QUANT = DTYPES[1:]
CFG = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=512,
           build_method="exact")          # the built_index fixture's config
STATS = ("fes_dist", "pilot_dist", "pilot_hops", "pilot_expanded",
         "refine_dist", "final_dist", "final_hops", "final_expanded",
         "total_cpu_dist")


def _bits(a) -> np.ndarray:
    """Raw bytes of an encoded table (bf16 as its 16-bit patterns)."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _table(seed, shape, spread=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if spread:
        x *= rng.uniform(0.1, 5.0, shape[-1]).astype(np.float32)
    x[..., -1, :] = 0.0                   # a zero (sentinel) row
    return x


# ---------------------------------------------------------------------------
# Encodings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(200, 24), (3, 40, 17)])
def test_quantize_bytes_equal_reference(dtype, shape):
    x = _table(sum(shape), shape)
    got, gside = TQ.quantize(x, dtype)
    want, wside = JQ.quantize(x, dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _bits(got).dtype == _bits(want).dtype
    if wside is None:
        assert gside is None
    else:
        np.testing.assert_array_equal(gside, wside)
    np.testing.assert_allclose(TQ.roundtrip_error_bound(x, dtype),
                               JQ.roundtrip_error_bound(x, dtype),
                               rtol=1e-6, atol=1e-6)


def test_bf16_rounds_to_nearest_even_like_reference():
    """Random data plus values exactly half an ulp between two bf16
    neighbours (both parities of the lower neighbour): torch's rounding
    gives the reference's bits."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=4096).astype(np.float32)
    hi16 = base.view(np.uint32) & np.uint32(0xFFFF0000)
    ties = (hi16 | np.uint32(0x8000)).view(np.float32)     # exact half-ulp
    x = np.concatenate([base, ties, -ties, np.float32([0.0, -0.0, 1e-40])])
    got, _ = TQ.quantize(x, "bfloat16")
    want, _ = JQ.quantize(x, "bfloat16")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got.view(torch.int16).numpy() & 1).any()      # both parities
    np.testing.assert_array_equal(
        TQ.dequantize(got).numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("d", [2, 7, 16, 33])
def test_int4_pack_unpack_equal_reference(d):
    rng = np.random.default_rng(d)
    codes = rng.integers(-8, 8, size=(50, d)).astype(np.int8)
    codes[0], codes[1] = -7, 7                             # both planes
    packed = TQ.int4_pack(codes)
    np.testing.assert_array_equal(packed, JQ.int4_pack(codes))
    assert packed.shape == (50, TQ.int4_packed_width(d))
    for data in (packed, torch.from_numpy(packed)):
        out = TQ.int4_unpack(data, d)
        out = out.numpy() if isinstance(out, torch.Tensor) else out
        np.testing.assert_array_equal(out, codes)
        full = TQ.int4_unpack(data)
        full = full.numpy() if isinstance(full, torch.Tensor) else full
        np.testing.assert_array_equal(full, np.asarray(JQ.int4_unpack(packed)))


@pytest.mark.parametrize("d", [1, 2, 5, 9, 16, 48, 96, 100])
def test_byte_formulas_equal_reference(d):
    assert TQ.pq_geometry(d) == JQ.pq_geometry(d)
    for dt in DTYPES:
        if dt == "int4" and d < 2:
            continue
        assert TQ.encoded_row_bytes(d, dt) == JQ.encoded_row_bytes(d, dt)
        assert TQ.side_bytes(d, dt) == JQ.side_bytes(d, dt)
    assert (TQ.PILOT_DTYPES, TQ.VEC_ITEMSIZE, TQ.FIDELITY, TQ.PQ_M,
            TQ.PQ_KSUB) == (JQ.PILOT_DTYPES, JQ.VEC_ITEMSIZE, JQ.FIDELITY,
                            JQ.PQ_M, JQ.PQ_KSUB)


@pytest.mark.parametrize("dtype", QUANT)
def test_decode_and_lut_match_reference(dtype):
    x = _table(11, (300, 20))
    data, side = JQ.quantize(x, dtype)
    scale, cb = (None, side) if dtype == "pq" else (side, None)
    tdata = torch.from_numpy(_bits(data))
    if dtype == "bfloat16":
        tdata = tdata.view(torch.bfloat16)
    ts = None if scale is None else torch.from_numpy(scale)
    tcb = None if cb is None else torch.from_numpy(cb)
    rows = np.arange(0, 300, 7)
    want = np.asarray(JQ.decode_rows(jnp.asarray(data)[rows],
                                     None if scale is None else jnp.asarray(scale),
                                     codebook=None if cb is None else jnp.asarray(cb)),
                      np.float32)
    got = TQ.decode_rows(tdata[rows], ts, codebook=tcb).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    round_trip = TQ.dequantize(*TQ.quantize(x, dtype))
    if isinstance(round_trip, torch.Tensor):              # bf16 in, torch out
        round_trip = round_trip.numpy()
    np.testing.assert_allclose(
        round_trip, np.asarray(JQ.dequantize(*JQ.quantize(x, dtype)), np.float32),
        rtol=1e-6, atol=1e-6)
    q = np.random.default_rng(2).normal(size=(6, 20)).astype(np.float32)
    if cb is not None:
        np.testing.assert_allclose(
            TQ.pq_lut(torch.from_numpy(q), tcb).numpy(),
            np.asarray(JQ.pq_lut(jnp.asarray(q), jnp.asarray(cb))),
            rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(
            TR.lane_pq_lut(torch.from_numpy(q), tcb).numpy(),
            np.asarray(JQ.pq_lut(jnp.asarray(q), jnp.asarray(cb))),
            rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        TQ.dequant_sq_dists(torch.from_numpy(q), tdata, ts, codebook=tcb).numpy(),
        np.asarray(JQ.dequant_sq_dists(jnp.asarray(q), jnp.asarray(data),
                                       None if scale is None else jnp.asarray(scale),
                                       codebook=None if cb is None else jnp.asarray(cb))),
        rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Plain kernel versions against the reference's Pallas kernels (interpret)
# ---------------------------------------------------------------------------

def _quant_hop_inputs(dtype, seed, n=600, R=8, d=16, Bq=12, ef=16):
    """``tests/test_quant.py``'s ``_random_quant_index`` inputs with an
    exact visited bitmap holding the beam."""
    rng = np.random.default_rng(seed)
    nbr = np.stack([rng.choice(n, R, replace=False) for _ in range(n)])
    nbr_t = np.concatenate([nbr, np.full((1, R), n)]).astype(np.int32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    data, side = JQ.quantize(np.concatenate([x, np.zeros((1, d), np.float32)]),
                             dtype)
    q = rng.normal(size=(Bq, d)).astype(np.float32)
    bid = rng.integers(0, n, (Bq, ef)).astype(np.int32)
    bd = np.sort(rng.random((Bq, ef)).astype(np.float32) * 40, axis=1)
    bck = rng.random((Bq, ef)) > 0.6
    bid[:, -3:], bd[:, -3:], bck[:, -3:] = n, np.inf, True
    vis = TB.exact_insert(TB.exact_init(Bq, n),
                          torch.from_numpy(np.where(bid < n, bid, 0)),
                          torch.from_numpy(bid < n)).numpy()
    scale, cb = (None, side) if dtype == "pq" else (side, None)
    j = [jnp.asarray(a) for a in (q, nbr_t, data, bid, bd, bck, vis)]
    tdata = torch.from_numpy(_bits(data))
    if dtype == "bfloat16":
        tdata = tdata.view(torch.bfloat16)
    t = [torch.from_numpy(a) for a in (q, nbr_t)] + [tdata] + [
        torch.from_numpy(a) for a in (bid, bd, bck, vis)]
    jside = dict(vec_scale=None if scale is None else jnp.asarray(scale),
                 vec_codebook=None if cb is None else jnp.asarray(cb))
    tside = dict(vec_scale=None if scale is None else torch.from_numpy(scale),
                 vec_codebook=None if cb is None else torch.from_numpy(cb))
    return j, t, jside, tside, n


def _match(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        if i == 1:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"output {i}")


@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("W", [1, 2])
def test_hop_ref_matches_interpret_kernel(dtype, W):
    j, t, jside, tside, n = _quant_hop_inputs(dtype, seed=5 + W)
    want = j_hop(*j, n, width=W, visited_mode="exact", interpret=True, **jside)
    _match(TR.traversal_hop_ref(*t, n, width=W, visited_mode="exact", **tside),
           want)
    # the wrapper runs the same plain version for CPU tensors
    _match(traversal_kernel.fused_traversal_hop(
        *t, n, width=W, visited_mode="exact", **tside), want)


@pytest.mark.parametrize("dtype", QUANT)
def test_pilot_search_ref_matches_interpret_kernel(dtype):
    j, t, jside, tside, n = _quant_hop_inputs(dtype, seed=9, n=500, Bq=8)
    want = j_pilot(*j, n, rounds=64, visited_mode="exact", interpret=True,
                   **jside)
    _match(TR.pilot_search_ref(*t, n, rounds=64, visited_mode="exact",
                               **tside), want)


@pytest.mark.parametrize("dtype", QUANT)
def test_fes_distances_ref_matches_interpret_kernel(dtype):
    rng = np.random.default_rng(17)
    r, QC, C, d = 4, 8, 128, 128
    q = rng.normal(size=(r, QC, d)).astype(np.float32)
    ev = rng.normal(size=(r, C, d)).astype(np.float32)
    data, side = JQ.quantize(ev, dtype)
    scale, cb = (None, side) if dtype == "pq" else (side, None)
    want = j_fes_distances(jnp.asarray(q), jnp.asarray(data),
                           scale=None if scale is None else jnp.asarray(scale),
                           codebook=None if cb is None else jnp.asarray(cb),
                           interpret=True)
    tdata = torch.from_numpy(_bits(data))
    if dtype == "bfloat16":
        tdata = tdata.view(torch.bfloat16)
    kw = dict(scale=None if scale is None else torch.from_numpy(scale),
              codebook=None if cb is None else torch.from_numpy(cb))
    for fn in (TR.fes_distances_ref, fes_kernel.fes_distances):
        np.testing.assert_allclose(fn(torch.from_numpy(q), tdata, **kw).numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fes_select_every_encoding_matches_reference(dtype):
    """Stage 0 with encoded entries: the port's plain selection and the
    card path's wrapper (``ops.fes_select``, plain on the CPU) give the
    reference's ids."""
    rng = np.random.default_rng(23)
    r, C, d, L, B = 8, 96, 24, 12, 50
    cent = rng.normal(size=(r, d)).astype(np.float32)
    ent = rng.normal(size=(r, C, d)).astype(np.float32)
    eid = rng.integers(0, 5000, (r, C)).astype(np.int32)
    val = rng.random((r, C)) > 0.1
    q = rng.normal(size=(B, d)).astype(np.float32)
    data, side = JQ.quantize(ent, dtype)
    scale, cb = (None, side) if dtype == "pq" else (side, None)
    want_ids, want_d = JF.fes_select_ref(
        *[jnp.asarray(a) for a in (q, cent, data, eid, val)], L,
        entries_scale=None if scale is None else jnp.asarray(scale),
        entries_codebook=None if cb is None else jnp.asarray(cb))
    tdata = torch.from_numpy(_bits(data))
    if dtype == "bfloat16":
        tdata = tdata.view(torch.bfloat16)
    t = [torch.from_numpy(a) for a in (q, cent)] + [tdata] + [
        torch.from_numpy(a) for a in (eid, val)]
    kw = dict(entries_scale=None if scale is None else torch.from_numpy(scale),
              entries_codebook=None if cb is None else torch.from_numpy(cb))
    for ids, dists in (TF.fes_select_ref(*t, L, **kw),
                       ops.fes_select(*t, L=L, **kw)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(dists.numpy(), np.asarray(want_d),
                                   rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Engine: search on the reference's state, all five pilot dtypes
# ---------------------------------------------------------------------------

def _reference_with(built_index, arrays):
    """A shallow copy of the reference index serving ``arrays`` (the
    session fixture itself is left as it is)."""
    ref = copy.copy(built_index)
    ref.arrays = arrays
    ref._search_fns = OrderedDict()
    return ref


@pytest.mark.parametrize("dtype", DTYPES)
def test_search_parity_every_pilot_dtype(built_index, small_dataset, dtype):
    """Final ids and every stats key identical to the reference, with
    persistent and per-hop stage ① on the port; final distances within
    rtol=1e-5, atol=1e-4."""
    arrays = dict(built_index.arrays,
                  **built_index._quantized_pilot_arrays(dtype))
    ref = _reference_with(built_index, arrays)
    port = PilotANNIndex.from_arrays(
        IndexConfig(**dict(CFG, pilot_dtype=dtype)), arrays,
        built_index.reducer.V, built_index.reducer.d_primary, device="cpu")
    for k, a in arrays.items():
        np.testing.assert_array_equal(_bits(port.arrays[k]), _bits(a), err_msg=k)
    q = small_dataset.queries[:64]
    want = ref.search(q, JSearchParams(k=10, ef=48, ef_pilot=48,
                                       use_persistent_traversal=True))
    for kw in ({"use_persistent_traversal": True},
               {"use_pallas_traversal": True}):
        got = port.search(q, SearchParams(k=10, ef=48, ef_pilot=48, **kw))
        np.testing.assert_array_equal(got[0], want[0], err_msg=str(kw))
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-4)
        for k in STATS:
            np.testing.assert_array_equal(got[2][k], np.asarray(want[2][k]),
                                          err_msg=f"{kw} {k}")


@pytest.fixture(scope="module")
def port_built(small_dataset):
    """A port-built CPU index at the fixture's config."""
    return PilotANNIndex(IndexConfig(**CFG), small_dataset.vectors,
                         device="cpu")


def test_port_encodes_like_reference(built_index, port_built):
    """The port's own build, re-encoded with ``set_pilot_dtype``, holds the
    reference's encoded tables bit for bit; ``memory_report`` agrees."""
    for dt in DTYPES:
        port_built.set_pilot_dtype(dt)
        want = built_index._quantized_pilot_arrays(dt)
        got = {k: v for k, v in port_built.arrays.items()
               if k in want or k.endswith(("_scale", "_codebook"))}
        assert set(got) == set(want), dt
        for k, a in want.items():
            np.testing.assert_array_equal(_bits(got[k]), _bits(a),
                                          err_msg=f"{dt} {k}")
        ref = _reference_with(built_index, dict(built_index.arrays, **want))
        ref.cfg = dataclasses.replace(built_index.cfg, pilot_dtype=dt)
        rep, wrep = port_built.memory_report(), ref.memory_report()
        for k in ("pilot_bytes", "pilot_graph_bytes", "pilot_vec_bytes",
                  "pilot_fes_bytes", "pilot_dtype"):
            assert rep[k] == wrep[k], (dt, k)
    port_built.set_pilot_dtype("float32")


def test_set_pilot_dtype_roundtrip(port_built):
    port_built.set_pilot_dtype("float32")
    before = port_built.arrays["primary"].clone()
    fp32_bytes = port_built.memory_report()
    port_built.set_pilot_dtype("int8")
    assert port_built.arrays["primary"].dtype == torch.int8
    assert "primary_scale" in port_built.arrays
    rep = port_built.memory_report()
    assert (fp32_bytes["pilot_vec_bytes"] + fp32_bytes["pilot_fes_bytes"]
            >= 3.5 * (rep["pilot_vec_bytes"] + rep["pilot_fes_bytes"]))
    port_built.set_pilot_dtype("pq")
    assert "primary_scale" not in port_built.arrays
    assert "primary_codebook" in port_built.arrays
    port_built.set_pilot_dtype("float32")
    assert not any(k.endswith(("_scale", "_codebook"))
                   for k in port_built.arrays)
    assert torch.equal(before, port_built.arrays["primary"])
    with pytest.raises(ValueError, match="pilot_dtype"):
        port_built.set_pilot_dtype("fp8")


def test_budget_enforced_on_set_pilot_dtype(small_dataset):
    """Widening past the budget raises and restores the previous encoding;
    the build itself refuses a budget it cannot meet, naming the planner."""
    n, d = small_dataset.vectors.shape
    pl = ResidencyPlanner(n, d, R=16, n_entry=512)
    budget = pl.estimate(0.35, 0.5, "int8")["total"] + 1024
    cfg = dataclasses.replace(
        ResidencyPlan(0.35, 0.5, "int8", 0, budget, 16, 512, 32).to_config(),
        build_method="exact")
    idx = PilotANNIndex(cfg, small_dataset.vectors, device="cpu")
    assert idx.memory_report()["pilot_bytes"] <= budget
    with pytest.raises(ValueError, match="pilot_budget_bytes"):
        idx.set_pilot_dtype("float32")
    assert idx.cfg.pilot_dtype == "int8"
    assert idx.arrays["primary"].dtype == torch.int8
    assert idx.memory_report()["pilot_bytes"] <= budget
    idx.set_pilot_dtype("pq")                       # narrower: allowed
    with pytest.raises(ValueError, match="ResidencyPlanner"):
        PilotANNIndex(dataclasses.replace(cfg, pilot_budget_bytes=1024),
                      small_dataset.vectors, device="cpu")


# ---------------------------------------------------------------------------
# ResidencyPlanner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,kw", [
    (1_000_000, 96, {}), (1_000_000, 128, dict(R=32, n_entry=8192)),
    (100_000, 96, dict(R=16, n_entry=2048, fes_clusters=16)),
    (4096, 64, dict(R=8, n_entry=512, pilot_id_dtype="int32")),
])
def test_planner_plans_like_reference(n, d, kw):
    tp, jp = ResidencyPlanner(n, d, **kw), JPlanner(n, d, **kw)
    top = tp.estimate(0.5, 0.75, "float32")["total"]
    for budget in [16, 10 ** 10] + [int(top * f) for f in
                                    (0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.6, 0.9)]:
        got, want = tp.plan(budget), jp.plan(budget)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), budget
        assert got.fits == want.fits
        cfg, wcfg = got.to_config(), want.to_config()
        for f in ("R", "n_entry", "fes_clusters", "sample_ratio", "svd_ratio",
                  "pilot_dtype", "pilot_id_dtype", "pilot_budget_bytes"):
            assert getattr(cfg, f) == getattr(wcfg, f), f
    for dt in DTYPES:
        assert tp.estimate(0.25, 0.5, dt) == jp.estimate(0.25, 0.5, dt)


def test_planner_estimate_matches_memory_report(port_built):
    cfg = port_built.cfg
    pl = ResidencyPlanner(port_built.n, port_built.d, R=cfg.R,
                          n_entry=cfg.n_entry, fes_clusters=cfg.fes_clusters)
    for dt in DTYPES:
        port_built.set_pilot_dtype(dt)
        rep = port_built.memory_report()
        est = pl.estimate(cfg.sample_ratio, cfg.svd_ratio, dt)
        assert est["graph"] == rep["pilot_graph_bytes"], dt
        assert est["vec"] == rep["pilot_vec_bytes"], dt
        assert est["fes"] >= rep["pilot_fes_bytes"], dt     # an upper bound
    port_built.set_pilot_dtype("float32")
