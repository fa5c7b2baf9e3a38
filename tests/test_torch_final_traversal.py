"""Stage ③ as one persistent launch (``kernels/traversal_kernel.
fused_final_search``), on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it bit
for bit against its plain version there).  Here:

* the dispatch (``core/traversal.takes_final_kernel``), decided from the
  device, the hooks and the shapes, with no card: the kernel for CUDA
  tensors with no hooks and a state that fits the block's shared memory;
  the torch round on the CPU, with hooks, for a spec that is not stage
  ③'s, and for an exact bitmap too large for shared memory;
* the wrapper on CPU tensors: its plain version, ``pilot_search_ref``, at
  the full widths of the benchmark's configurations (d 96 and 200);
* S1's gate: on ``built_index``, a search whose stage ③ runs the kernel's
  plain version gives the torch stage ③'s ids and every stats key, and
  distances within the fp32 bound of two summation orders,
  2.5e-5·(‖q‖² + ‖x‖²).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import IndexConfig, PilotANNIndex, SearchParams
from repro_torch.core import bloom as TB
from repro_torch.core import multistage as TM
from repro_torch.core import traversal as TT
from repro_torch.kernels import ref as TR, traversal_kernel as TK

torch.set_num_threads(1)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
CFG = dict(R=16, sample_ratio=0.35, svd_ratio=0.5, n_entry=512,
           build_method="exact")          # the built_index fixture's config


def _table(n: int, d: int, dtype=torch.float32) -> torch.Tensor:
    """An (n+1, d) table with no storage: only its shape and dtype are
    read."""
    return torch.empty((n + 1, d), dtype=dtype, device="meta")


@pytest.mark.parametrize("case,want", [
    # deep1m's and syn200's stage ③: bloom 16,384 bits, ef 128, R 32
    (dict(d=96), True),
    (dict(d=200), True),
    # rows too wide for the tile: the layout without it still fits
    (dict(d=768, W=4), True),
    # an exact bitmap of 1M + 1 bits (125 KB packed) fits, of 2M + 1 not
    (dict(d=96, exact_n=1_000_000), True),
    (dict(d=96, exact_n=2_000_000), False),
    (dict(d=96, device=CPU), False),
    (dict(d=96, hooked=True), False),
    (dict(d=96, spec="pilot"), False),
])
def test_dispatch_takes_the_kernel_only_where_it_can(case, want):
    """``takes_final_kernel`` on shapes and devices alone."""
    d, W = case["d"], case.get("W", 1)
    params = SearchParams(ef=128, frontier_width=W)
    spec = (TM.pilot_spec(params) if case.get("spec") == "pilot"
            else TM.final_spec(params))
    if "exact_n" in case:
        spec = TM.final_spec(SearchParams(ef=128, visited_mode="exact"))
        vbits = case["exact_n"] + 1
    else:
        vbits = spec.bloom_bits
    hooked = case.get("hooked", False)      # the pod's hooks: no table
    got = TT.takes_final_kernel(
        spec, case.get("device", CUDA),
        None if hooked else _table(1000, 32, torch.int32),
        _table(1000, d), torch.empty((128, vbits), dtype=torch.bool,
                                     device="meta"),
        hooked=hooked)
    assert got is want


@pytest.mark.parametrize("dq,W,R,vbits,row_bytes,tiled,fits", [
    (96, 1, 32, 16384, 384, True, True),         # deep1m's stage ③
    (200, 1, 32, 16384, 800, True, True),        # syn200's
    (384, 4, 32, 16384, 1536, True, True),       # 192 KB of tile
    (384, 4, 48, 16384, 1536, False, True),      # 288 KB of tile: none
    (96, 1, 32, 2_000_001, 384, False, False),   # 250 KB of filter
])
def test_host_layout_takes_the_tile_where_it_fits(dq, W, R, vbits, row_bytes,
                                                  tiled, fits):
    """``smem_bytes`` (the host's ``choose_layout``): the layout with the
    tile of the round's W·R rows where it fits the limit, else the one
    without it; ``launch_smem`` reads it off a table's shape."""
    got = TK.smem_bytes(dq, 128, W, R, vbits, False, 0, row_bytes)
    bare = TK.smem_bytes(dq, 128, W, R, vbits, False, 0, 0)
    assert got - bare == (W * R * row_bytes if tiled else 0)
    assert (got <= TK.SMEM_LIMIT) == fits
    assert TK.launch_smem(_table(10, dq), ef=128, width=W, R=R,
                          vbits=vbits) == got


def _inputs(B, R, ef, d, n, seed, mode="bloom"):
    """A random R-regular digraph, random vectors, a sorted beam with
    sentinels, and the beam inserted into the visited filter (CPU)."""
    rng = np.random.default_rng(seed)
    nbr = np.concatenate([rng.integers(0, n, (n, R)),
                          np.full((1, R), n)]).astype(np.int32)
    vec = np.concatenate([rng.normal(size=(n, d)),
                          np.zeros((1, d))]).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    bid = rng.integers(0, n, (B, ef)).astype(np.int32)
    bd = np.sort(rng.random((B, ef)).astype(np.float32) * 4 * d, axis=1)
    bck = rng.random((B, ef)) > 0.6
    bid[:, -3:], bd[:, -3:], bck[:, -3:] = n, np.inf, True
    live = torch.from_numpy(bid < n)
    key = torch.from_numpy(np.where(bid < n, bid, 0))
    vis = (TB.bloom_insert(TB.bloom_init(B, 16384), key, live)
           if mode == "bloom" else TB.exact_insert(TB.exact_init(B, n), key,
                                                   live))
    return [torch.from_numpy(a) for a in (q, nbr, vec, bid, bd, bck)] + [vis]


@pytest.mark.parametrize("d,mode,tomb", [(96, "bloom", False),
                                         (200, "bloom", True),
                                         (96, "exact", True)])
def test_wrapper_on_cpu_tensors_is_the_plain_version(d, mode, tomb):
    """``fused_final_search`` on CPU tensors: ids, distances, flags, filter
    and the three counters of ``pilot_search_ref``, over rounds that run to
    convergence."""
    n = 1500
    t = _inputs(6, 32, 128, d, n, seed=d, mode=mode)
    kw = dict(rounds=512, visited_mode=mode)
    if tomb:
        dead = torch.zeros(n + 1, dtype=torch.bool)
        dead[torch.randperm(n, generator=torch.Generator().manual_seed(d))
             [:n // 20]] = True
        kw["tombstone"] = dead
    got = TK.fused_final_search(*t, n, **kw)
    want = TR.pilot_search_ref(*t, n, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[5].max()) > 1                  # several rounds ran
    assert (want[0][:, 0] < n).all()


@pytest.fixture(scope="module")
def port_index(built_index):
    """The port over the reference's built state, on the CPU."""
    return PilotANNIndex.from_arrays(
        IndexConfig(**CFG),
        {k: np.asarray(v) for k, v in built_index.arrays.items()},
        built_index.reducer.V, built_index.reducer.d_primary, device="cpu")


@pytest.mark.parametrize("path,kw", [
    ("search", {}),
    ("search", {"use_refine": False}),
    ("search", {"use_pilot": False}),
    ("search", {"visited_mode": "exact"}),
    ("baseline", {}),
])
def test_plain_stage3_kernel_matches_the_torch_rounds(port_index,
                                                      small_dataset,
                                                      monkeypatch, path, kw):
    """S1's gate: the dispatch told that the CPU is the card runs stage ③
    as ``fused_final_search``, whose CPU body is the kernel's plain
    version; ids and every stats key equal the torch stage ③'s, and each
    distance is within 2.5e-5·(‖q‖² + ‖x‖²)."""
    params = SearchParams(k=10, ef=48, ef_pilot=48,
                          use_persistent_traversal=True, **kw)
    q = small_dataset.queries[:64]
    run = (port_index.search_baseline if path == "baseline"
           else port_index.search)
    want = run(q, params)

    calls = []
    real_takes, real_search = TT.takes_final_kernel, TK.fused_final_search

    def takes(spec, device, *a, **k):
        return real_takes(spec, CUDA, *a, **k)

    def counted(*a, **k):
        calls.append(1)
        return real_search(*a, **k)

    monkeypatch.setattr(TT, "takes_final_kernel", takes)
    monkeypatch.setattr(TK, "fused_final_search", counted)
    got = run(q, params)
    assert calls == [1]                            # stage ③ took the kernel
    np.testing.assert_array_equal(got[0], want[0])
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)
    qr = port_index.rotate_queries(q)
    x = port_index.arrays["rot_vecs"][torch.from_numpy(got[0]).long()]
    bound = 2.5e-5 * ((qr * qr).sum(-1)[:, None] + (x * x).sum(-1)).numpy()
    assert (np.abs(got[1] - want[1]) <= bound).all()
