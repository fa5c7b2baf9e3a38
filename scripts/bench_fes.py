#!/usr/bin/env python3
"""Time the stage-0 FES kernels K3/K4 (``fes_tile_kernel``) and K5
(``fes_pq_kernel``) against an earlier version of them on one NVIDIA GPU,
and hold the two versions' outputs bit for bit.

    mkdir -p build/fes_old
    git show <rev>:src/repro_torch/csrc/fes.cu > build/fes_old/fes.cu
    git show <rev>:src/repro_torch/kernels/fes_kernel.py \\
        > build/fes_old/fes_kernel.py
    python3 scripts/bench_fes.py --old build/fes_old [--n 1000000]

The earlier source is compiled with the port's nvcc flags into ``build/``
and driven through its own wrapper, so each version's event time carries
its own host cost (the earlier int4 wrapper pads the queries and the scale
with torch ops).

Shapes:
  * the main path's: the deep-``--n`` index ``chip_smoke.py`` builds, its
    first ``--batch`` queries grouped by ``ops.group_queries`` with
    capacity B (r 32, QC 128, d 48 at 1M: most slots are zero rows), against
    the index's ``fes_entries`` (C 512) in each of the five pilot
    encodings (``set_pilot_dtype``);
  * ragged: r 5, QC 70, C 130, d 47 (odd: the int4 rows carry a pad
    nibble), and wide: the same at d 200 (K3/K4 stage such rows through
    their ring of d-chunks); random queries, once dense and once with two
    thirds of the slots zero rows and one row of values around 1e-30 (its
    squared norm underflows to 0 but the row is not zero).
For each shape and encoding: the two versions' outputs bit-equal
(``torch.equal`` on the int32 views), each within rtol 1e-4 of the plain
version; then in turns (a, b, b, a) the CUDA-event median of ``--reps``
calls around the wrapper and the profiler's device time per launch
(``chip_smoke``'s ``time_ms`` and ``device_ms``), beside the bound
(``chip_smoke.fes_bound``: bytes moved, and the operations of the occupied
slots).  At fp32 also ``torch.cdist(qg, ev).square()``, the library call
of the same function: its event time and the device time of every kernel
it launches.  Prints the card's name and power limit first, then one JSON
line per shape and encoding; exits 1 if any output differs.
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

ROOT = Path(__file__).resolve().parents[1]
DTYPES = ("float32", "bfloat16", "int8", "int4", "pq")


def load_version(wrapper: Path, lib_path: Path):
    """The wrapper module at ``wrapper``, driving the library at
    ``lib_path`` in place of the one ``_build`` would load."""
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    shim = types.SimpleNamespace(**{k: getattr(_build, k) for k in dir(_build)
                                    if not k.startswith("__")})
    shim.load = lambda _name: lib
    spec = importlib.util.spec_from_file_location("bench_fes_old", wrapper)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = shim
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory holding the earlier fes.cu and "
                         "fes_kernel.py")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_fes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import chip_smoke
    from repro_torch.core import quant as Q
    from repro_torch.core.engine import IndexConfig, PilotANNIndex
    from repro_torch.data import preset_dataset
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fes_kernel as FK
    from repro_torch.kernels.ref import fes_distances_ref

    print(chip_smoke.smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    out = _build.build_dir() / "bench_fes"
    out.mkdir(parents=True, exist_ok=True)
    old_lib = out / "libfes_old.so"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(old_lib), str(args.old / "fes.cu")])
    _build.build_all(["fes", "build"])
    if proc.wait():
        raise SystemExit("nvcc failed")
    versions = {"old": load_version(args.old / "fes_kernel.py", old_lib),
                "new": FK}
    names = list(versions)
    order = names + names[::-1]                   # a, b, b, a
    print(f"[build] {time.perf_counter() - t0:.1f} s; versions {names}",
          flush=True)
    failed = []

    def compare(shape, qg, ev, side, d):
        """Both versions against each other (bits) and the plain version
        (rtol 1e-4), then timed in turns; one JSON line."""
        kw = dict(scale=side.get("scale"), codebook=side.get("codebook"))
        want = fes_distances_ref(qg, ev, **kw)
        got = {k: m.fes_distances(qg, ev, **kw) for k, m in versions.items()}
        torch.cuda.synchronize()
        bits = {k: g.view(torch.int32) for k, g in got.items()}
        equal = all(torch.equal(bits[k], bits[names[0]]) for k in names)
        err = {k: float((g - want).abs().max()) for k, g in got.items()}
        close = {k: bool(torch.allclose(g, want, rtol=1e-4, atol=1e-4 * d))
                 for k, g in got.items()}
        if not equal:
            failed.append(f"{shape}: versions differ")
        failed.extend(f"{shape}: {k} not within 1e-4 of the plain version"
                      for k, ok in close.items() if not ok)
        ev_ms = {k: [] for k in names}
        dev_ms = {k: [] for k in names}
        for name in order:
            fn = lambda: versions[name].fes_distances(qg, ev, **kw)
            ev_ms[name].append(chip_smoke.time_ms(torch, fn, reps=args.reps))
            dev_ms[name].append(chip_smoke.device_ms(
                torch, fn, chip_smoke.FES_EVENT, reps=args.reps))
        r, QC, _ = qg.shape
        C = ev.shape[1]
        occ = int((qg != 0).any(-1).sum())
        enc = shape.split()[-1]
        cb = kw["codebook"]
        bound, by = chip_smoke.fes_bound(
            r, QC, C, d, occ, Q.encoded_row_bytes(d, enc),
            Q.side_bytes(d, enc),
            pq=None if cb is None else (cb.shape[1], ev.shape[2]))
        row = dict(shape=shape, r=r, QC=QC, C=C, d=d, occupied_slots=occ,
                   bit_equal=equal, max_abs_err=err, within_1e4=close,
                   event_ms=ev_ms, device_ms=dev_ms, bound_ms=bound,
                   bound_by=by, share_of_bound={
                       k: [None if t is None else bound / t for t in v]
                       for k, v in dev_ms.items()})
        if enc == "float32":
            lib = lambda: torch.cdist(qg, ev).square()
            row["cdist_event_ms"] = chip_smoke.time_ms(torch, lib,
                                                       reps=args.reps)
            row["cdist_device_ms"] = chip_smoke.device_ms(torch, lib, "",
                                                          reps=args.reps)
        print(json.dumps(row), flush=True)

    # ---- the main path's grouped batch on the deep index ----------------
    t0 = time.perf_counter()
    ds = preset_dataset("deep", args.n, n_queries=1024, seed=args.seed)
    index = PilotANNIndex(IndexConfig(build_method="nn_descent",
                                      seed=args.seed), ds.vectors)
    torch.cuda.synchronize()
    A = index.arrays
    dp = A["primary"].shape[1]
    qp = index.rotate_queries(ds.queries[:args.batch])[:, :dp].contiguous()
    qg, _ = ops.group_queries(qp, A["fes_centroids"], qp.shape[0])
    print(f"[index] deep n={args.n} built in {time.perf_counter() - t0:.1f} s;"
          f" grouped batch {tuple(qg.shape)}, entries "
          f"{tuple(A['fes_entries'].shape)}", flush=True)
    for dt in DTYPES:
        if dt != "float32":
            index.set_pilot_dtype(dt)
        A = index.arrays
        compare(f"main {dt}", qg, A["fes_entries"],
                dict(scale=A.get("fes_entries_scale"),
                     codebook=A.get("fes_entries_codebook")), dp)
    del index

    # ---- ragged: r 5, QC 70, C 130, d 47; and wide rows, d 200 ----------
    rng = np.random.default_rng(args.seed)
    r, QC, C = 5, 70, 130
    for tag0, d in (("ragged", 47), ("wide", 200)):
        qd = rng.normal(size=(r, QC, d)).astype(np.float32)
        qz = qd.copy()
        qz[:, QC // 3:] = 0.0                 # two thirds zero rows
        qz[1, 0] = 1e-30                      # its qn underflows to +0
        x = rng.normal(size=(r, C, d)).astype(np.float32)
        for dt in DTYPES:
            data, side = Q.quantize(x, dt)
            data = (data if isinstance(data, torch.Tensor)
                    else torch.from_numpy(data))
            side = None if side is None else torch.from_numpy(side).to(dev)
            sides = dict(codebook=side) if dt == "pq" else dict(scale=side)
            for tag, q in (("dense", qd), ("zero rows", qz)):
                compare(f"{tag0} {tag} {dt}", torch.from_numpy(q).to(dev),
                        data.to(dev), sides, d)
    if failed:
        print("bench_fes: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
