#!/usr/bin/env python3
"""Time the stage-① traversal kernels K1 (``fused_pilot_search``) and K2
(``fused_traversal_hop``) against an earlier version of them on one NVIDIA
GPU, at the main path's shapes on the deep-1M index ``chip_smoke.py``
builds (or on a ``--preset`` index of ``--n`` points, e.g. ``laion``:
d 768, pilot width dp 384).

    mkdir -p build/k12_old
    git show <rev>:src/repro_torch/csrc/traversal.cu > build/k12_old/traversal.cu
    git show <rev>:src/repro_torch/kernels/traversal_kernel.py \\
        > build/k12_old/traversal_kernel.py
    python3 scripts/bench_traversal.py --old build/k12_old [--n 1000000]
                                       [--preset deep]

The earlier source is compiled with the port's nvcc flags into ``build/``
and driven through its own wrapper, so each version's event time carries
its own host cost.

Shapes (B 128 queries, ef 128, the index's R, dp and id width):
  * K1 from the FES start state (``init_state`` on ``ops.fes_select``'s
    entries), fp32 and, after ``set_pilot_dtype("pq")``, pq; and K1 with
    rounds = 0, which only loads the state, packs the visited filter and
    unpacks it again;
  * K2 from a mid-search state (three plain rounds past the start), W 1
    and 4;
  * one batch of per-hop ``search`` traced with torch.profiler, each
    version's K2 patched in: K2's device time per launch against the CUDA
    events around its wrapper;
  * end to end, every query (``--queries``, in batches of ``--batch``)
    through ``search`` (K1) and per-hop ``search`` (K2) with each
    version's kernels patched in, in turns: QPS, and ids equal across
    versions.
Every version is held bit for bit against the plain version on each shape
(ids, distance bits, flags, visited bits, fresh masks, counters), then timed
in turns (a, b, b, a for two versions): the CUDA-event median of ``--reps``
calls around the wrapper, and the profiler's device time per launch
(``chip_smoke``'s ``time_ms`` and ``device_ms``).  K1's rows add the
slowest query's rounds (its ``n_hops``) and the device µs per round.
Prints the card's name and power limit first, then one JSON line per
shape.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


def load_version(name: str, wrapper: Path, lib_path: Path):
    """The wrapper module at ``wrapper``, driving the library at
    ``lib_path`` in place of the one ``_build`` would load."""
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    shim = types.SimpleNamespace(**{k: getattr(_build, k) for k in dir(_build)
                                    if not k.startswith("__")})
    shim.load = lambda _name: lib
    spec = importlib.util.spec_from_file_location(f"bench_{name}", wrapper)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = shim
    mod.fused_traversal_hop.launches = 0
    mod.fused_pilot_search.launches = 0
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory holding the earlier traversal.cu and "
                         "traversal_kernel.py")
    ap.add_argument("--preset", default="deep",
                    help="preset_dataset name of the index (deep: d 96)")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-pq", action="store_true",
                    help="leave out the pq pilot (its encode is ~30 s of "
                         "host k-means)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_traversal: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import quant as Q
    from repro_torch.core import traversal as T
    from repro_torch.core.engine import IndexConfig, PilotANNIndex
    from repro_torch.core.multistage import SearchParams
    from repro_torch.data import preset_dataset
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import traversal_kernel as TK
    from repro_torch.kernels.ref import pilot_search_ref, traversal_hop_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    out = _build.build_dir() / "bench_traversal"
    out.mkdir(parents=True, exist_ok=True)
    old_lib = out / "libtraversal_old.so"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(old_lib), str(args.old / "traversal.cu")])
    _build.build_all(["traversal", "fes", "build"])
    if proc.wait():
        raise SystemExit("nvcc failed")
    versions = {"old": load_version("old", args.old / "traversal_kernel.py",
                                    old_lib),
                "new": TK}
    names = list(versions)
    order = names + names[::-1]                   # a, b, b, a
    print(f"[build] {time.perf_counter() - t0:.1f} s; versions {names}",
          flush=True)

    t0 = time.perf_counter()
    ds = preset_dataset(args.preset, args.n, n_queries=args.queries,
                        seed=args.seed)
    index = PilotANNIndex(IndexConfig(build_method="nn_descent",
                                      seed=args.seed), ds.vectors)
    torch.cuda.synchronize()
    A = index.arrays
    nk = index.n_pilot
    nbr = A["sub_neighbors"]
    dp = A["primary"].shape[1]
    R = nbr.shape[1]
    id_bytes = nbr.element_size()
    qp = index.rotate_queries(ds.queries[:args.batch])[:, :dp].contiguous()
    B = qp.shape[0]
    ef = 128
    print(f"[index] {args.preset} n={args.n} built in {time.perf_counter() - t0:.1f} s; "
          f"pilot nk={nk}, R={R}, dp={dp}, {8 * id_bytes}-bit ids",
          flush=True)

    def time_ms(fn):
        return chip_smoke.time_ms(torch, fn, reps=args.reps)

    def device_ms(fn):
        return chip_smoke.device_ms(torch, fn, chip_smoke.TRAVERSAL,
                                    reps=args.reps)

    def same_bits(got, want):
        try:
            chip_smoke.same_bits(torch, got, want, "", range(len(want)))
        except chip_smoke.CheckFailed:
            return False
        return True

    def compare(shape, call, want, extra):
        """Hold every version against the plain outputs, then time them in
        turns; one JSON line."""
        row = dict(shape=shape, **extra)
        row["bit_equal"] = {name: same_bits(call(mod), want)
                            for name, mod in versions.items()}
        failed.extend(f"{k} at {shape}" for k, ok in row["bit_equal"].items()
                      if not ok)
        ev = {k: [] for k in names}
        devt = {k: [] for k in names}
        for name in order:
            fn = lambda: call(versions[name])
            ev[name].append(time_ms(fn))
            devt[name].append(device_ms(fn))
        row["event_ms"], row["device_ms"] = ev, devt
        hops = extra.get("rounds_slowest")
        if hops:
            row["us_per_round"] = {
                k: [None if t is None else 1e3 * t / hops for t in v]
                for k, v in devt.items()}
        print(json.dumps(row), flush=True)
        return row

    failed = []
    beam_bytes = B * ef * (4 + 4 + 1)
    filt_bytes = B * T.TraversalSpec(ef=ef).bloom_bits

    def k1_rows(dt):
        A = index.arrays
        vec = A["primary"]
        side = dict(vec_scale=A.get("primary_scale"),
                    vec_codebook=A.get("primary_codebook"))
        ev_ = A["fes_entries"]
        entry, _ = ops.fes_select(
            qp, A["fes_centroids"], ev_, A["fes_entry_ids"], A["fes_valid"],
            L=SearchParams().fes_L, entries_scale=A.get("fes_entries_scale"),
            entries_codebook=A.get("fes_entries_codebook"))
        spec = T.TraversalSpec(ef=ef)
        st = T.init_state(spec, qp, entry, vec, nk, **side)
        k1 = (qp, nbr, vec, st.cand_id, st.cand_d, st.checked, st.visited, nk)
        row_b, side_b = Q.encoded_row_bytes(dp, dt), Q.side_bytes(dp, dt)
        for rounds in (512, 0):
            want = pilot_search_ref(*k1, rounds=rounds, **side)
            hops = int(want[5].max())
            nbytes = (int(want[4].sum()) * row_b
                      + int(want[6].sum()) * R * id_bytes + B * dp * 4
                      + side_b + 2 * beam_bytes + 2 * filt_bytes + B * 12)
            compare(f"K1 {dt} rounds<={rounds}",
                    lambda m: m.fused_pilot_search(*k1, rounds=rounds, **side),
                    want, dict(B=B, ef=ef, R=R, dp=dp, id_bits=8 * id_bytes,
                               rounds_slowest=hops,
                               mean_hops=float(want[5].float().mean()),
                               bound_ms=1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S))

    k1_rows("float32")

    # K2 from a mid-search state, W 1 and 4
    A = index.arrays
    vec = A["primary"]
    entry, _ = ops.fes_select(qp, A["fes_centroids"], A["fes_entries"],
                              A["fes_entry_ids"], A["fes_valid"],
                              L=SearchParams().fes_L)
    for W in (1, 4):
        spec = T.TraversalSpec(ef=ef, frontier_width=W)
        st = T.init_state(spec, qp, entry, vec, nk)
        for _ in range(3):
            st = T.expansion_round(spec, st, qp, nbr, vec, nk)
        hop = (qp, nbr, vec, st.cand_id, st.cand_d, st.checked, st.visited,
               nk)
        want = traversal_hop_ref(*hop, width=W)
        unchecked = ~st.checked & (st.cand_id < nk)
        n_sel = int(unchecked.sum(1).clamp(max=W).sum())
        nbytes = (int(want[4].sum()) * dp * 4 + n_sel * R * id_bytes
                  + B * dp * 4 + 2 * beam_bytes + 2 * filt_bytes + B * W * R)
        compare(f"K2 float32 W={W}",
                lambda m: m.fused_traversal_hop(*hop, width=W), want,
                dict(B=B, ef=ef, R=R, dp=dp, W=W,
                     bound_ms=1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S))

    # one batch of per-hop search with each version's K2 patched in: K2's
    # device time per launch (profiler) against the CUDA events around its
    # wrapper, and the batch's wall time
    from torch.profiler import ProfilerActivity, profile
    params = SearchParams(k=10, ef=128, ef_pilot=128,
                          use_pallas_traversal=True)
    queries = ds.queries[:B]
    path = {}
    for name in order:
        mod = versions[name]
        marks = []

        def timed_hop(*a, _f=mod.fused_traversal_hop, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            r = _f(*a, **kw)
            e.record()
            marks.append((s, e))
            return r

        timed_hop.launches = 0     # the wrapper counts on its global name
        with mock.patch.object(TK, "fused_traversal_hop", timed_hop):
            index.search(queries, params)                       # warm
            torch.cuda.synchronize()
            marks.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                index.search(queries, params)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and chip_smoke.TRAVERSAL in e.name]
        ev_ms = sum(s.elapsed_time(e) for s, e in marks)
        path.setdefault(name, []).append(dict(
            launches=len(marks), device_events=len(us),
            device_ms_per_launch=(sum(us) / 1e3 / len(us)) if us else None,
            event_ms_per_launch=ev_ms / max(1, len(marks)),
            traced_batch_wall_ms=1e3 * wall))
    print(json.dumps({"shape": "per-hop search, one traced batch", "B": B,
                      "versions": path}), flush=True)

    # end to end: every query through ``search`` (persistent stage ①, K1)
    # and per-hop ``search`` (K2), each version's kernels patched in, in
    # turns: QPS, and the ids, which must not depend on the version
    import numpy as np
    for path, params in (
            ("search", SearchParams(k=10, ef=128, ef_pilot=128,
                                    use_persistent_traversal=True)),
            ("search_per_hop", SearchParams(k=10, ef=128, ef_pilot=128,
                                            use_pallas_traversal=True))):
        qps, ids_of = {k: [] for k in names}, {}
        for name in order:
            mod = versions[name]
            with mock.patch.object(TK, "fused_pilot_search",
                                   mod.fused_pilot_search), \
                    mock.patch.object(TK, "fused_traversal_hop",
                                      mod.fused_traversal_hop):
                index.search(ds.queries[:B], params)             # warm
                ids, secs = [], 0.0
                for s in range(0, len(ds.queries), B):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    i, _, _ = index.search(ds.queries[s:s + B], params)
                    secs += time.perf_counter() - t0
                    ids.append(i)
            qps[name].append(len(ds.queries) / secs)
            ids_of[name] = np.concatenate(ids)
        same = {k: bool(np.array_equal(v, ids_of["old"]))
                for k, v in ids_of.items()}
        failed.extend(f"{k} ids at {path}" for k, ok in same.items() if not ok)
        print(json.dumps({"shape": f"{path}, {len(ds.queries)} queries in "
                          f"batches of {B}", "qps": qps,
                          "ids_equal_to_old": same}), flush=True)

    if not args.no_pq:
        t0 = time.perf_counter()
        index.set_pilot_dtype("pq")
        print(f"[pq] encoded in {time.perf_counter() - t0:.1f} s", flush=True)
        k1_rows("pq")
    if failed:
        print("bench_traversal: differs from the plain version: "
              + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
