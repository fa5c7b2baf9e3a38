#!/usr/bin/env python3
"""Where a torch.profiler trace loses device events, on one GPU.

    python3 scripts/probe_device_events.py

Builds a DEEP-shaped 200,000-vector index on the card and traces 20
calls of the FES kernel three times, plain; after 20 s of threaded numpy
matmul on the host; after ``set_pilot_dtype("pq")`` (the pq encode);
with int8 entries; and with pq again (and once with 40 calls).  Each
trace prints (device events held, kernel launches seen on the host, all
device events, first held kernel's start minus the first launch's start
in µs, last launch's start minus last held kernel's start in µs).  A
first-kernel offset of milliseconds means the trace lost its first
events; ``chip_smoke.device_ms`` leads each trace with uncounted calls
for that reason.
"""
import sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import IndexConfig, PilotANNIndex
from repro_torch.data import preset_dataset
from repro_torch.kernels import fes_distances, ops

def trace(fn, name, reps=20):
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = sorted(e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name)
    launches = sorted(e.time_range.start for e in prof.events()
                      if e.device_type != torch.autograd.DeviceType.CUDA and "LaunchKernel" in e.name)
    alld = [e.name[:40] for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(dev), len(launches), len(alld),
            round(dev[0] - launches[0], 1) if dev and launches else None,
            round(launches[-1] - dev[-1], 1) if dev and launches else None)

ds = preset_dataset("deep", 200_000, n_queries=128, seed=0)
index = PilotANNIndex(IndexConfig(build_method="nn_descent", seed=0), ds.vectors)
A = index.arrays
qp = index.rotate_queries(ds.queries)[:, :48].contiguous()
qg, _ = ops.group_queries(qp, A["fes_centroids"], 128)
f = lambda: fes_distances(qg, A["fes_entries"])
print("fp32 K3:", [trace(f, "fes_") for _ in range(3)], flush=True)
t0 = time.perf_counter()
x = np.random.default_rng(0).normal(size=(4000, 4000)).astype(np.float32)
while time.perf_counter() - t0 < 20:
    x = x @ x.T / 4000.0
print("fp32 K3 after 20 s of host BLAS:", [trace(f, "fes_") for _ in range(3)], flush=True)
index.set_pilot_dtype("pq")
A = index.arrays
f = lambda: fes_distances(qg, A["fes_entries"], codebook=A["fes_entries_codebook"])
print("pq K5 after set_pilot_dtype:", [trace(f, "fes_") for _ in range(3)], flush=True)
index.set_pilot_dtype("int8")
A = index.arrays
f = lambda: fes_distances(qg, A["fes_entries"], scale=A["fes_entries_scale"])
print("int8 K3:", [trace(f, "fes_") for _ in range(3)], flush=True)
index.set_pilot_dtype("pq")
A = index.arrays
f = lambda: fes_distances(qg, A["fes_entries"], codebook=A["fes_entries_codebook"])
print("pq K5 again:", [trace(f, "fes_") for _ in range(3)], flush=True)
print("pq K5, 40 reps:", trace(f, "fes_", 40), flush=True)
