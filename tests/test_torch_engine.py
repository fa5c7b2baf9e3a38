"""PyTorch port vs the JAX reference, end to end: build parity, search
parity on identical index state, no silent CPU fallback, import hygiene."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import SearchParams as JSearchParams
from repro_torch.core import IndexConfig, PilotANNIndex, SearchParams
from repro_torch.core import graph_build as TGB
from repro_torch.core.engine import arrays_from_numpy, resolve_device

# Small tensors and many ops: one intra-op thread is faster, and leaves the
# cores to the other pytest workers of a parallel run.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=512,
           build_method="exact")          # the built_index fixture's config
STATS = ("fes_dist", "pilot_dist", "pilot_hops", "pilot_expanded",
         "refine_dist", "final_dist", "final_hops", "final_expanded",
         "total_cpu_dist")


@pytest.fixture(scope="module")
def port_index(built_index):
    """The port over the reference's built state."""
    return PilotANNIndex.from_arrays(
        IndexConfig(**CFG), {k: np.asarray(v) for k, v in built_index.arrays.items()},
        built_index.reducer.V, built_index.reducer.d_primary, device="cpu")


def test_build_parity(built_index, small_dataset):
    """Same seed, same build: every array equal (keys, dtypes, values) and
    the same SVD rotation."""
    idx = PilotANNIndex(IndexConfig(**CFG), small_dataset.vectors,
                        device="cpu")
    assert list(idx.arrays) == list(built_index.arrays)
    for k, want in built_index.arrays.items():
        got = idx.arrays[k].numpy()
        want = np.asarray(want)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(idx.reducer.V, built_index.reducer.V)
    assert idx.reducer.d_primary == built_index.reducer.d_primary
    rep = idx.memory_report()
    want_rep = built_index.memory_report()
    for k in ("pilot_bytes", "full_bytes", "pilot_graph_bytes",
              "pilot_vec_bytes", "pilot_fes_bytes", "pilot_nodes",
              "d_primary", "pilot_id_dtype"):
        assert rep[k] == want_rep[k], k


@pytest.mark.parametrize("variant", [
    {"use_persistent_traversal": True},
    {"use_pallas_traversal": True},
    {"use_persistent_traversal": True, "frontier_width_pilot": 2},
    "baseline",
])
def test_search_parity(built_index, port_index, small_dataset, variant):
    """Identical ids, every stats key identical, distances within
    rtol=1e-5, atol=1e-4."""
    q = small_dataset.queries
    if variant == "baseline":
        want = built_index.search_baseline(q, JSearchParams(k=10, ef=48, ef_pilot=48))
        got = port_index.search_baseline(q, SearchParams(k=10, ef=48, ef_pilot=48))
    else:
        fw = variant.get("frontier_width_pilot", 1)
        want = built_index.search(q, JSearchParams(k=10, ef=48, ef_pilot=48,
                                                   frontier_width_pilot=fw))
        got = port_index.search(q, SearchParams(k=10, ef=48, ef_pilot=48,
                                                **variant))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-4)
    assert set(got[2]) == set(want[2]) == set(STATS)
    for k in STATS:
        np.testing.assert_array_equal(got[2][k], np.asarray(want[2][k]), err_msg=k)


def test_search_parity_ablations(built_index, port_index, small_dataset):
    """The disabled-stage paths (coarse entries instead of FES, no refine,
    no pilot) and exact visited bitmaps, on a ragged batch of 37."""
    q = small_dataset.queries[:37]
    for kw in ({"use_fes": False}, {"use_refine": False},
               {"use_pilot": False}, {"visited_mode": "exact"}):
        want = built_index.search(q, JSearchParams(k=10, ef=32, ef_pilot=32, **kw))
        got = port_index.search(q, SearchParams(k=10, ef=32, ef_pilot=32,
                                                use_persistent_traversal=True, **kw))
        np.testing.assert_array_equal(got[0], want[0], err_msg=str(kw))
        for k in STATS:
            np.testing.assert_array_equal(got[2][k], np.asarray(want[2][k]),
                                          err_msg=f"{kw} {k}")


def test_no_cpu_fallback(built_index, small_dataset):
    """Entry points run on the card unless the caller asks for the CPU;
    without a card they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    arrays = {k: np.asarray(v) for k, v in built_index.arrays.items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PilotANNIndex(IndexConfig(**CFG), small_dataset.vectors[:500])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PilotANNIndex.from_arrays(IndexConfig(**CFG), arrays,
                                  built_index.reducer.V,
                                  built_index.reducer.d_primary)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arrays_from_numpy(arrays)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TGB.build_graph(small_dataset.vectors[:100], 8, method="nn_descent")
    assert resolve_device("cpu").type == "cpu"


def test_unported_options_raise(built_index, small_dataset):
    """Every pilot_dtype of the reference is ported; what lies outside the
    reference's option sets raises, and so does re-encoding an index that
    holds no host pilot rows."""
    with pytest.raises(ValueError, match="pilot_dtype"):
        PilotANNIndex(IndexConfig(**dict(CFG, pilot_dtype="fp8")),
                      small_dataset.vectors[:500], device="cpu")
    with pytest.raises(ValueError, match="build method"):
        TGB.build_graph(small_dataset.vectors[:100], 8, method="nope")
    carried = PilotANNIndex.from_arrays(
        IndexConfig(**CFG), dict(built_index.arrays), built_index.reducer.V,
        built_index.reducer.d_primary, device="cpu")
    with pytest.raises(ValueError, match="from_arrays"):
        carried.set_pilot_dtype("int8")
    assert arrays_from_numpy({"primary": np.zeros((3, 2), np.int8)},
                             "cpu")["primary"].dtype == torch.int8


def test_preset_dataset_parity():
    from repro.data.pipeline import preset_dataset as j_preset
    from repro_torch.data import preset_dataset as t_preset
    a, b = t_preset("deep", 1500, n_queries=16, seed=3), j_preset(
        "deep", 1500, n_queries=16, seed=3)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    np.testing.assert_array_equal(a.queries, b.queries)
    assert a.name == b.name


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\s|\.|,|$)"
                        r"|from\s+repro(\s|\.))", re.M)


def test_import_hygiene():
    """The port and chip_smoke.py import neither JAX nor the JAX package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


@pytest.mark.parametrize("B", [1, 8, 9, 100, 128, 129, 300])
def test_bucket_ladder_parity(B):
    from repro.core import multistage as JM
    from repro_torch.core import multistage as TM
    assert TM.BATCH_BUCKETS == JM.BATCH_BUCKETS
    assert TM.bucket_size(B) == JM.bucket_size(B)
    q = np.random.default_rng(B).normal(size=(B, 4)).astype(np.float32)
    got, b = TM.pad_to_bucket(torch.from_numpy(q))
    want, wb = JM.pad_to_bucket(q)
    assert b == wb == B
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
