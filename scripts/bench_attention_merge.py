#!/usr/bin/env python3
"""Time the expand-merge K6 (``csrc/topk.cu``) and K8's fp32 flash
attention kernel (``csrc/flash_attention.cu``) against earlier versions of them on
one NVIDIA GPU, and hold every version against the plain versions.

    mkdir -p build/k68_old
    for f in csrc/topk.cu csrc/sort.cuh csrc/flash_attention.cu \\
             csrc/hopper.cuh kernels/topk_kernel.py \\
             kernels/flash_attention.py; do
        git show <rev>:src/repro_torch/$f > build/k68_old/$(basename $f)
    done
    python3 scripts/bench_attention_merge.py --old build/k68_old

Both versions (``old``, and the working tree as ``new``) are compiled
with the port's nvcc flags plus ``-Xptxas -v`` into
``build/bench_attention_merge/``, all at once, and each is driven through
its own wrapper.  The script prints each kernel's registers
and spills as ptxas reports them, then one JSON line per shape:

  * K6 at the stage-① shape (B 128, ef 128, R 32, d 48) and at a shape
    where bytes decide (B 8,192, same widths, about 72 MB), with fp32 and
    with bf16 neighbour vectors, on a sorted beam; at B 128 also an
    unsorted beam and R 48 (the kernel's block-sort route).  Outputs of
    every version bit-equal to ``kernels/ref.expand_merge_ref``; the bound
    counts q, the (B, R, d) rows, ids and flags, and the beam in and out,
    once each.
  * K8 fp32 at chip_smoke's shape (B 2, Sq 384, Sk 640, H 16/4, D 128),
    non-causal, causal, and with peaked scores (q x 8): max abs error
    against ``kernels/ref.flash_attention_ref`` (1e-4), beside
    ``F.scaled_dot_product_attention``'s time, error and the kernels it
    ran (the yardstick; the port never calls it).  Both fp32 bounds: the
    fp32 cores (4·B·H·Sq·Sk·D at 67 TFLOP/s) and 3xTF32 on the tensor
    cores (three times the work at 495 TFLOP/s).
  * K8 bf16 at D 16, 32 and 96 (the fp32 kernel's bf16 head dims; 3e-2).

Times: in turns (old, new, new, old) the CUDA-event median of ``--reps``
calls around the wrapper and the profiler's device time per call
(``chip_smoke``'s ``time_ms`` and ``device_ms``).  Prints the card's name
and power limit first; exits 1 if ``old`` or ``new`` disagrees with a
plain version.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
FP32_SHAPE = (2, 384, 640, 16, 4, 128)          # chip_smoke phase 6


def ptxas_summary(log: str, keep=("expand_merge", "fp32", "f32")) -> list:
    """(kernel, registers, spill stores, spill loads) for each entry
    function of a ``-Xptxas -v`` log whose name holds one of ``keep``."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and any(k in name for k in keep):
            rows.append((demangle(name), int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return rows


def demangle(name: str) -> str:
    """The kernel's name and template arguments, without its parameters."""
    tool = shutil.which("c++filt")
    if tool is None:
        return name
    full = subprocess.run([tool, name], capture_output=True,
                          text=True).stdout.strip()
    m = re.search(r"(\w+(?:<[^()]*>)?)\(",
                  full.replace("(anonymous namespace)", ""))
    return m.group(1) if m else full


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory holding the earlier sources and "
                         "wrappers")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_attention_merge: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import numpy as np
    import torch.nn.functional as F

    import chip_smoke
    from bench_fes import load_version
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import expand_merge_ref, flash_attention_ref

    print(chip_smoke.smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- build every version at once, with ptxas's report ---------------
    dirs = {"old": (args.old, args.old), "new": (CSRC, KERNELS)}
    out = _build.build_dir() / "bench_attention_merge"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, (src, _) in dirs.items():
        for lib in ("topk", "flash_attention"):
            if (src / f"{lib}.cu").exists():
                so = out / f"lib{lib}_{name}.so"
                procs[name, lib] = (so, subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                     "-o", str(so), str(src / f"{lib}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
    versions = {"topk": {}, "flash_attention": {}}
    for (name, lib), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} {lib}.cu failed:\n{log}")
        for kern, regs, st, ld in ptxas_summary(log):
            print(f"[ptxas] {name} {kern}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads", flush=True)
        wrapper = dirs[name][1] / ("topk_kernel.py" if lib == "topk"
                                   else "flash_attention.py")
        versions[lib][name] = load_version(wrapper, so)
    print(f"[build] {time.perf_counter() - t0:.1f} s; versions "
          f"{list(dirs)}", flush=True)
    failed = []

    def turns(names, row, call, event):
        """Event and device times of each version in turns a, b, .., b, a."""
        ev_ms = {k: [] for k in names}
        dev_ms = {k: [] for k in names}
        for name in list(names) + list(names)[::-1]:
            fn = lambda: call(name)
            ev_ms[name].append(chip_smoke.time_ms(torch, fn, reps=args.reps))
            dev_ms[name].append(chip_smoke.device_ms(torch, fn, event,
                                                     reps=args.reps))
        row.update(event_ms=ev_ms, device_ms=dev_ms)
        return dev_ms

    # ---- K6 -------------------------------------------------------------
    rng = np.random.default_rng(args.seed)

    def k6_inputs(B, ef, R, d, vec_dtype, sorted_beam):
        n = 1_000_000
        bd = np.sort(rng.random((B, ef)).astype(np.float32) * 50, axis=1)
        bid = rng.integers(0, n, (B, ef)).astype(np.int32)
        tail = ef // 8                          # sentinels at the end
        bid[:, ef - tail:], bd[:, ef - tail:] = n, np.float32(3.0e38)
        if not sorted_beam:
            perm = rng.permuted(np.tile(np.arange(ef), (B, 1)), axis=1)
            bd = np.take_along_axis(bd, perm, 1)
            bid = np.take_along_axis(bid, perm, 1)
        arrs = (rng.normal(size=(B, d)).astype(np.float32),
                rng.normal(size=(B, R, d)).astype(np.float32),
                rng.integers(0, n, (B, R)).astype(np.int32),
                rng.random((B, R)) < 0.5, bid, bd, rng.random((B, ef)) > 0.5)
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        t[1] = t[1].to(vec_dtype)
        return (*t, n)

    k6 = versions["topk"]
    for tag, B, R, vdt, srt in (
            ("stage-1", 128, 32, torch.float32, True),
            ("stage-1", 128, 32, torch.bfloat16, True),
            ("bandwidth", 8192, 32, torch.float32, True),
            ("bandwidth", 8192, 32, torch.bfloat16, True),
            ("stage-1 unsorted beam", 128, 32, torch.float32, False),
            ("stage-1 R 48", 128, 48, torch.float32, True)):
        ef, d = 128, 48
        a = k6_inputs(B, ef, R, d, vdt, srt)
        want = expand_merge_ref(*a)
        equal = {}
        for name, mod in k6.items():
            got = mod.fused_expand_merge(*a)
            equal[name] = all(
                torch.equal(g.view(torch.int32) if g.is_floating_point()
                            else g, w.view(torch.int32)
                            if w.is_floating_point() else w)
                for g, w in zip(got, want))
            if not equal[name]:
                failed.append(f"K6 {tag} {vdt}: {name} differs from the "
                              f"plain version")
        row = dict(kernel="K6 fused_expand_merge", shape=tag, B=B, ef=ef,
                   R=R, d=d, vectors=str(vdt)[6:], bit_equal=equal)
        dev_ms = turns(list(k6), row,
                       lambda name: k6[name].fused_expand_merge(*a),
                       "expand_merge")
        row["plain_event_ms"] = chip_smoke.time_ms(
            torch, lambda: expand_merge_ref(*a), reps=5, warmup=1)
        nbytes = (B * d * 4 + B * R * (d * a[1].element_size() + 4 + 1)
                  + 2 * B * ef * (4 + 4 + 1))
        bound = 1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S
        row.update(bound_ms=bound, bound_by="bytes", bytes=nbytes,
                   share_of_bound={k: [None if t is None else bound / t
                                       for t in v]
                                   for k, v in dev_ms.items()})
        print(json.dumps(row), flush=True)
        del a, want

    # ---- K8 -------------------------------------------------------------
    k8 = versions["flash_attention"]
    g = torch.Generator(device=dev).manual_seed(args.seed)

    def qkv(B, Sq, Sk, H, Hkv, D, dtype, q_scale=1.0):
        q, k, v = [torch.randn((B, S, h, D), generator=g, device=dev)
                   for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv))]
        return (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)

    def bounds(shape, causal):
        B, Sq, Sk, H, _, D = shape
        pairs = (sum(min(r + 1, Sk) for r in range(Sq)) if causal
                 else Sq * Sk)
        flops = 4.0 * B * H * pairs * D
        return dict(gflop=flops / 1e9,
                    bound_fp32_cores_ms=1e3 * flops / chip_smoke.FP32_FLOPS_PER_S,
                    bound_3xtf32_ms=1e3 * 3 * flops / chip_smoke.TF32_FLOPS_PER_S)

    for tag, shape, dtype, causal, q_scale, tol in (
            ("fp32", FP32_SHAPE, torch.float32, False, 1.0, 1e-4),
            ("fp32 causal", FP32_SHAPE, torch.float32, True, 1.0, 1e-4),
            ("fp32 peaked (q x 8)", FP32_SHAPE, torch.float32, False, 8.0,
             1e-4),
            ("bf16 D 16", (2, 300, 520, 16, 4, 16), torch.bfloat16, True,
             1.0, 3e-2),
            ("bf16 D 32", (2, 300, 520, 16, 4, 32), torch.bfloat16, True,
             1.0, 3e-2),
            ("bf16 D 96", (2, 300, 520, 16, 4, 96), torch.bfloat16, True,
             1.0, 3e-2)):
        q, k, v = qkv(*shape, dtype, q_scale)
        want = flash_attention_ref(q, k, v, causal=causal).float()
        err = {}
        for name, mod in k8.items():
            got = mod.flash_attention(q, k, v, causal=causal).float()
            err[name] = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
            if not ok:
                failed.append(f"K8 {tag}: {name} max abs err {err[name]}")
        row = dict(kernel="K8 flash_attention", shape=tag,
                   B_Sq_Sk_H_Hkv_D=list(shape), dtype=str(dtype)[6:],
                   causal=causal, tol=tol, max_abs_err=err,
                   **bounds(shape, causal))
        dev_ms = turns(list(k8), row,
                       lambda name: k8[name].flash_attention(
                           q, k, v, causal=causal), "flash_fwd")
        row["share_3xtf32"] = {k: [None if t is None else
                                   row["bound_3xtf32_ms"] / t for t in vals]
                               for k, vals in dev_ms.items()}
        row["share_fp32_cores"] = {
            k: [None if t is None else row["bound_fp32_cores_ms"] / t
                for t in vals] for k, vals in dev_ms.items()}
        if dtype == torch.float32:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            row["sdpa_max_abs_err"] = float(
                (sdpa().transpose(1, 2).float() - want).abs().max())
            row["sdpa_event_ms"] = chip_smoke.time_ms(torch, sdpa,
                                                      reps=args.reps)
            row["sdpa_device_ms"] = chip_smoke.device_ms(torch, sdpa, "",
                                                         reps=args.reps)
            row["sdpa_kernels"] = chip_smoke.kernel_names(torch, sdpa)
            row["plain_event_ms"] = chip_smoke.time_ms(
                torch, lambda: flash_attention_ref(q, k, v, causal=causal))
        print(json.dumps(row), flush=True)
        del q, k, v, want
    if failed:
        print("bench_attention_merge: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
