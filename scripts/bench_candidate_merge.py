#!/usr/bin/env python3
"""Time the candidate-merge kernel (K7) against an earlier version of it on
one NVIDIA GPU, at the three shapes of the NN-descent build.

    git show <rev>:src/repro_torch/csrc/build.cu > build/k7_old/build.cu
    git show <rev>:src/repro_torch/csrc/sort.cuh > build/k7_old/sort.cuh
    python3 scripts/bench_candidate_merge.py --old build/k7_old [--n 1000000]

The shapes are the seeding merge (K 64 random proposals into sentinel
incumbents), the first local-join round (P 784, incumbents from the
seeding) and a late round (after ROUNDS - 1 rounds), on the DEEP-shaped
vectors ``chip_smoke.py`` indexes (``preset_dataset("deep", n)``).  Both
kernels are held bit for bit against the plain merge; each is timed with
CUDA events (median of 10 after warm-up) in turns, old, new, new, old, and
the two runs of each are printed.  The old source must export the same C
interface (``candidate_merge``); it is compiled with the port's nvcc flags
into ``build/``.  Prints the card's name and power limit first and one JSON
line per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory holding the earlier build.cu (and the "
                         "headers it includes)")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_candidate_merge: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import device_build as DB
    from repro_torch.data import preset_dataset
    from repro_torch.kernels import _build, fused_candidate_merge
    from repro_torch.kernels.ref import candidate_merge_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = _build.build_dir() / "k7_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(args.old / "build.cu")], check=True)
    old = ctypes.CDLL(str(out))
    old.candidate_merge.restype = ctypes.c_int
    old.candidate_merge.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                    + [ctypes.c_void_p])

    def run_old(ci, cd, pi, pd, n):
        B, K = ci.shape
        P = pi.shape[1]
        oid = torch.empty((B, K), dtype=torch.int32, device=ci.device)
        od = torch.empty((B, K), dtype=torch.float32, device=ci.device)
        rc = old.candidate_merge(*(_build.ptr(t) for t in (ci, cd, pi, pd,
                                                            oid, od)),
                                 B, K, P, n, _build.next_pow2(K + P),
                                 _build.stream_of(ci))
        if rc:
            raise RuntimeError(f"old candidate_merge: CUDA error {rc}")
        return oid, od

    def time_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    dev = torch.device("cuda")
    ds = preset_dataset("deep", args.n, n_queries=8, seed=args.seed)
    x_pad = DB._pad_rows(torch.from_numpy(ds.vectors).to(dev))
    n, K, S = args.n, 64, 16
    for shape in ("seeding", "first round", "late round"):
        with torch.no_grad():
            xsq = (x_pad * x_pad).sum(-1)
            if shape == "seeding":
                ids = torch.full((n, K), n, dtype=torch.int32, device=dev)
                dd = torch.full((n, K), 3.0e38, device=dev)
                props = torch.from_numpy(np.random.default_rng(
                    args.seed).integers(0, n, (n, K)).astype(np.int32)).to(dev)
            else:
                ids, dd = DB._nn_descent(
                    x_pad, K, rounds=0 if shape == "first round"
                    else DB.ROUNDS - 1, S=S, seed=args.seed, block=None)
                props = DB._proposals(ids, n, S, local=True)
            dp = DB._score(x_pad, xsq, props, n, None)
        k7 = (ids, dd, props, dp, n)
        wi, wd = candidate_merge_ref(*k7)
        for name, fn in (("old", run_old), ("new", fused_candidate_merge)):
            gi, gd = fn(*k7)
            if not (torch.equal(gi, wi)
                    and torch.equal(gd.view(torch.int32), wd.view(torch.int32))):
                raise SystemExit(f"{name} K7 differs from the plain merge "
                                 f"at the {shape} shape")
        del wi, wd, gi, gd
        t = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            fn = run_old if name == "old" else fused_candidate_merge
            t[name].append(time_ms(lambda: fn(*k7)))
        P = props.shape[1]
        print(json.dumps({
            "shape": shape, "n": n, "K": K, "P": P, "bit_equal": True,
            "old_ms": t["old"], "new_ms": t["new"],
            "bound_ms": 1e3 * 8.0 * n * (2 * K + P) / HBM_BYTES_PER_S}),
            flush=True)
        del k7, ids, dd, props, dp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
