"""The port's compiled-call layer against the reference's: the shape-bucketed
search cache (``tests/test_serving.py``'s cases, run against the port), and
the chunked convergence loop that the card replays as CUDA graphs, held
against the reference's ``lax.while_loop`` at several chunk sizes.

On the CPU the cache holds plain callables and the loop runs eagerly; the
same loop (``traversal.run_to_convergence`` / ``chunk_sizes``) is what the
card's captured chunks replay (``tests/test_torch_cuda.py`` holds graph
against eager there)."""

import copy
import dataclasses
from collections import OrderedDict

import numpy as np
import pytest
import torch

from repro.core import SearchParams as JSearchParams
from repro_torch.core import IndexConfig, PilotANNIndex, SearchParams
from repro_torch.core import multistage as TM
from repro_torch.core import traversal as TT

# Small tensors and many ops: one intra-op thread is faster, and leaves the
# cores to the other pytest workers of a parallel run.
torch.set_num_threads(1)

CFG = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=512,
           build_method="exact")          # the built_index fixture's config
PARAMS = SearchParams(k=10, ef=32, ef_pilot=32)
STATS = ("fes_dist", "pilot_dist", "pilot_hops", "pilot_expanded",
         "refine_dist", "final_dist", "final_hops", "final_expanded",
         "total_cpu_dist")
DTYPES = ("float32", "bfloat16", "int8", "int4", "pq")


def _port(built_index, arrays=None, **cfg):
    arrays = built_index.arrays if arrays is None else arrays
    return PilotANNIndex.from_arrays(
        IndexConfig(**dict(CFG, **cfg)),
        {k: np.asarray(v) for k, v in arrays.items()},
        built_index.reducer.V, built_index.reducer.d_primary, device="cpu")


@pytest.fixture
def port_index(built_index):
    """A fresh port index over the reference's state (its own cache)."""
    return _port(built_index)


def _reference_with(built_index, arrays):
    """A shallow copy of the reference index serving ``arrays``, with its
    own jit cache (the session fixture itself is left as it is)."""
    ref = copy.copy(built_index)
    ref.arrays = arrays
    ref._search_fns = OrderedDict()
    return ref


def _same(got, want, what):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]), err_msg=what)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5,
                               atol=1e-4, err_msg=what)
    assert set(got[2]) == set(want[2]) == set(STATS), what
    for k in STATS:
        np.testing.assert_array_equal(got[2][k], np.asarray(want[2][k]),
                                      err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# The shape-bucketed compiled-search cache (tests/test_serving.py:155-210)
# ---------------------------------------------------------------------------

def test_search_bucketed_compile_count(port_index, small_dataset):
    """A sweep over batch sizes 1..65 compiles exactly one search per rung
    of the ladder it touches: 8, 16, 32, 64, 128."""
    params = dataclasses.replace(PARAMS, ef=24, ef_pilot=24)
    before = port_index.compile_count(params, baseline=False)
    for B in range(1, 66):
        ids, dists, stats = port_index.search(small_dataset.queries[:B],
                                              params)
        assert ids.shape == (B, params.k) and dists.shape == (B, params.k)
        assert stats["pilot_dist"].shape == (B,)
    compiled = port_index.compile_count(params, baseline=False) - before
    assert 0 < compiled <= len(port_index.batch_buckets), compiled
    assert compiled == 5
    assert port_index.compile_count(params, baseline=True) == 0


def test_search_bucket_padding_is_result_invariant(built_index, port_index,
                                                   small_dataset):
    """The bucket-padded engine search returns what an unpadded direct call
    of ``multistage_search`` returns, and the reference's ids."""
    B = 13                                    # pads to bucket 16
    rot = port_index.rotate_queries(small_dataset.queries[:B])
    ids_ref, d_ref, st_ref = TM.multistage_search(port_index.arrays, PARAMS,
                                                  rot)
    ids, dists, stats = port_index.search(small_dataset.queries[:B], PARAMS)
    assert np.array_equal(ids, ids_ref.numpy())
    np.testing.assert_allclose(dists, d_ref.numpy(), rtol=1e-6)
    for k in STATS:
        np.testing.assert_array_equal(stats[k], st_ref[k].numpy(), err_msg=k)
    want = built_index.search(small_dataset.queries[:B],
                              JSearchParams(k=10, ef=32, ef_pilot=32))
    _same((ids, dists, stats), want, "B=13")


def test_warmup_precompiles_all_buckets(port_index):
    params = dataclasses.replace(PARAMS, ef=20, ef_pilot=20)
    assert port_index.compile_count(params) == 0
    assert port_index.warmup(params, buckets=(8, 16)) == 2
    assert port_index.compile_count(params, baseline=False) == 2
    # warmed sizes do not compile again
    port_index.search(np.asarray(port_index.reducer.rotate(
        np.zeros((3, port_index.d), np.float32))), params, rotated=True)
    assert port_index.compile_count(params, baseline=False) == 2
    assert port_index.warmup(params, baseline=True, buckets=(8,)) == 1
    assert port_index.compile_count(params, baseline=True) == 1
    assert port_index.compile_count() == 3


def test_compiled_cache_is_lru_bounded(built_index, small_dataset):
    """At capacity 2, a third params key evicts the least recently used
    one; ``cache_stats`` and ``jit_evictions`` count it."""
    index = _port(built_index, jit_cache_capacity=2)
    q = small_dataset.queries[:8]
    pa, pb, pc = (dataclasses.replace(PARAMS, ef=e, ef_pilot=e)
                  for e in (16, 20, 24))
    index.search(q, pa)
    index.search(q, pb)
    index.search(q, pa)                       # pa is now the most recent
    assert index.cache_stats() == {"cached_executables": 2, "capacity": 2,
                                   "jit_evictions": 0}
    index.search(q, pc)                       # evicts pb
    assert index.jit_evictions == 1
    assert index.cache_stats() == {"cached_executables": 2, "capacity": 2,
                                   "jit_evictions": 1}
    assert index.compile_count(pb) == 0
    assert index.compile_count(pa) == index.compile_count(pc) == 1
    index.search(q, pb)                       # evicts pa
    assert index.jit_evictions == 2 and index.compile_count(pa) == 0


# ---------------------------------------------------------------------------
# Cache invalidation: a replaced tensor of ``arrays`` drops the cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_built(small_dataset):
    """A port-built CPU index at the fixture's config (it keeps the host
    fp32 pilot rows, so ``set_pilot_dtype`` works)."""
    return PilotANNIndex(IndexConfig(**CFG), small_dataset.vectors,
                         device="cpu")


def test_set_pilot_dtype_drops_compiled_searches(built_index, port_built,
                                                 small_dataset):
    """After ``set_pilot_dtype`` a search runs the new encoding's tables
    (the reference's ids for that encoding), not the ones its cached
    program was compiled over; the drop is neither an eviction nor a
    compile."""
    q = small_dataset.queries[:32]
    port_built.set_pilot_dtype("float32")
    ids32, _, st32 = port_built.search(q, PARAMS)
    assert port_built.compile_count(PARAMS) == 1
    evicted = port_built.jit_evictions
    port_built.set_pilot_dtype("pq")
    assert port_built.compile_count() == 0
    assert port_built.jit_evictions == evicted
    got = port_built.search(q, PARAMS)
    ref = _reference_with(built_index, dict(
        built_index.arrays, **built_index._quantized_pilot_arrays("pq")))
    _same(got, ref.search(q, JSearchParams(k=10, ef=32, ef_pilot=32)), "pq")
    # the pq pilot's own stage ①, not the fp32 program's
    assert not np.array_equal(got[2]["pilot_dist"], st32["pilot_dist"])
    # any other replacement of a tensor of ``arrays`` drops it too
    assert port_built.compile_count() == 1
    port_built.arrays["primary"] = port_built.arrays["primary"].clone()
    assert port_built.compile_count() == 0
    port_built.set_pilot_dtype("float32")
    np.testing.assert_array_equal(port_built.search(q, PARAMS)[0], ids32)


# ---------------------------------------------------------------------------
# The chunked convergence loop
# ---------------------------------------------------------------------------

def test_chunk_sizes():
    assert list(TT.chunk_sizes(20, 8)) == [8, 8, 4]
    assert list(TT.chunk_sizes(3, 8)) == [3]
    assert list(TT.chunk_sizes(0, 8)) == []
    assert list(TT.chunk_sizes(512, 8)) == [8] * 64
    assert list(TT.chunk_sizes(7, 3)) == [3, 3, 1]


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_run_to_convergence_tests_once_a_chunk(port_index, small_dataset,
                                               monkeypatch, chunk):
    """One host test before each chunk: ceil(rounds / chunk) + 1 of them
    for a loop that converges inside ``max_rounds``, and the same state
    whatever the chunk."""
    tests = []
    pending = TT.pending
    monkeypatch.setattr(TT, "pending", lambda s, n: tests.append(1) or
                        pending(s, n))
    A = port_index.arrays
    n = A["rot_vecs"].shape[0] - 1
    q = port_index.rotate_queries(small_dataset.queries[:16])
    spec = TT.TraversalSpec(ef=32)
    entries = A["coarse_ids"][:4].expand(16, 4)
    st1 = TT.init_state(spec, q, entries, A["rot_vecs"], n)
    round_fn = lambda s: TT.expansion_round(spec, s, q, A["full_neighbors"],
                                            A["rot_vecs"], n)
    monkeypatch.setattr(TT, "CHUNK", 1)
    want = TT.run_to_convergence(round_fn, st1, n, 512)
    rounds = int(want.n_hops.max())
    tests.clear()
    monkeypatch.setattr(TT, "CHUNK", chunk)
    got = TT.run_to_convergence(round_fn, st1, n, 512)
    assert len(tests) == -(-rounds // chunk) + 1
    for g, w, f in zip(got, want, TT.SearchState._fields):
        assert torch.equal(g, w), f


def _converged_rows(st, n):
    return ~(~st.checked & (st.cand_id < n)).any(1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_converged_round_is_a_fixed_point(built_index, dtype):
    """A round on a converged query changes no field of its state, counters
    and visited bits included: stage ③'s torch round and stage ①'s per-hop
    round (K2's plain version) for each pilot encoding, at every round
    from the start until the whole batch has converged (so on batches where
    some queries have converged and others have not).  The chunked loop,
    and the card's replayed chunks, rest on it."""
    arrays = dict(built_index.arrays,
                  **built_index._quantized_pilot_arrays(dtype))
    A = _port(built_index, arrays).arrays
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(24, A["rot_vecs"].shape[1]))
                         .astype(np.float32))
    nk = A["pilot_to_full"].shape[0] - 1
    n = A["rot_vecs"].shape[0] - 1
    scale, cb = A.get("primary_scale"), A.get("primary_codebook")
    dp = TT.quant.primary_dim(A["primary"], scale, codebook=cb)
    qp = q[:, :dp].contiguous()
    side = dict(vec_scale=scale, vec_codebook=cb)
    cases = [
        (TT.TraversalSpec(ef=24, use_pallas=True), qp, A["sub_neighbors"],
         A["primary"], nk, A["fes_entry_ids"][0, :4].expand(24, 4), side),
        (TT.TraversalSpec(ef=24), q, A["full_neighbors"], A["rot_vecs"], n,
         A["coarse_ids"][:4].expand(24, 4), {}),
    ]
    for spec, qq, nbr, vec, nn, entries, kw in cases:
        s = TT.init_state(spec, qq, entries, vec, nn, **kw)
        mixed = False
        for _ in range(spec.max_iters):
            done = _converged_rows(s, nn)
            nxt = TT.expansion_round(spec, s, qq, nbr, vec, nn, **kw)
            for f, a, b in zip(TT.SearchState._fields, s, nxt):
                assert torch.equal(a[done], b[done]), (dtype, spec, f)
            if bool(done.all()):
                break
            mixed |= bool(done.any())
            s = nxt
        assert mixed and bool(done.all()), (dtype, spec)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_loop_matches_reference(built_index, small_dataset,
                                        monkeypatch, dtype):
    """``search`` (persistent and per-hop stage ①) and, with the fp32 pilot,
    ``search_baseline``: ids and every stats key equal to the reference's,
    distances within float noise, at chunk sizes 1, 3 and 8, with
    ``max_iters`` 3 (every loop cut) and 512."""
    arrays = (built_index.arrays if dtype == "float32" else dict(
        built_index.arrays, **built_index._quantized_pilot_arrays(dtype)))
    ref = _reference_with(built_index, arrays)
    q = small_dataset.queries[:48]
    for max_iters in (3, 512):
        jp = JSearchParams(k=10, ef=40, ef_pilot=40, max_iters=max_iters)
        want = ref.search(q, jp)
        want_base = (ref.search_baseline(q, jp) if dtype == "float32"
                     else None)
        for chunk in (1, 3, 8):
            monkeypatch.setattr(TT, "CHUNK", chunk)
            port = _port(built_index, arrays, pilot_dtype=dtype)
            for kw in ({"use_persistent_traversal": True},
                       {"use_pallas_traversal": True}):
                p = SearchParams(k=10, ef=40, ef_pilot=40,
                                 max_iters=max_iters, **kw)
                _same(port.search(q, p), want,
                      f"{dtype} max_iters={max_iters} chunk={chunk} {kw}")
            if want_base is not None:
                _same(port.search_baseline(q, p), want_base,
                      f"baseline max_iters={max_iters} chunk={chunk}")
