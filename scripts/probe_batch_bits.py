#!/usr/bin/env python3
"""Which operations of the search give other bits for another batch size
on one GPU.

    python3 scripts/probe_batch_bits.py

First, each torch operation of the distance path on random fp32 inputs of
the main path's shapes: the first B rows computed alone against the same
rows inside a batch of P (B 1 / P 8, 13 / 16, 100 / 128, 8 / 128), True
where every bit is equal.  Then the deep-1M index (``build_method=
"nn_descent"``): ``multistage_search`` / ``baseline_search`` eagerly on
128 queries in batches of B, unpadded against padded to the bucket:
rows whose ids differ, rows whose distance bits differ, the largest
relative distance difference and the stats keys that differ.
"""
import sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.core import IndexConfig, PilotANNIndex, SearchParams
from repro_torch.core import multistage as M, traversal as T
from repro_torch.data import preset_dataset
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)

def same(a, b):
    return bool(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                            b.view(torch.int32) if b.is_floating_point() else b))

for B, P in ((1, 8), (13, 16), (100, 128), (8, 128)):
    q = torch.randn(P, 96, device=dev, generator=g)
    v = torch.randn(P, 32, 96, device=dev, generator=g)
    tab = torch.randn(15625, 96, device=dev, generator=g)
    cen = torch.randn(32, 48, device=dev, generator=g)
    r = {}
    r["einsum bd,brd"] = same(torch.einsum("bd,brd->br", q[:B], v[:B]), torch.einsum("bd,brd->br", q, v)[:B])
    r["sum q*q"] = same((q[:B] * q[:B]).sum(-1), (q * q).sum(-1)[:B])
    r["sum v*v"] = same((v[:B] * v[:B]).sum(-1), (v * v).sum(-1)[:B])
    r["q @ tab.T"] = same(q[:B] @ tab.T, (q @ tab.T)[:B])
    r["q48 @ cen.T"] = same(q[:B, :48] @ cen.T, (q[:, :48] @ cen.T)[:B])
    r["sq_dists batched"] = same(T.sq_dists(q[:B], v[:B]), T.sq_dists(q, v)[:B])
    r["sq_dists table"] = same(T.sq_dists(q[:B], tab), T.sq_dists(q, tab)[:B])
    print(f"B={B} vs {P}:", r, flush=True)

ds = preset_dataset("deep", 1_000_000, n_queries=256, seed=0)
t0 = time.perf_counter()
index = PilotANNIndex(IndexConfig(build_method="nn_descent", seed=0), ds.vectors)
print(f"index {time.perf_counter() - t0:.1f} s", flush=True)
for name, base, params in (("search", False, SearchParams(k=10, ef=128, ef_pilot=128, use_persistent_traversal=True)),
                           ("per_hop", False, SearchParams(k=10, ef=128, ef_pilot=128, use_pallas_traversal=True)),
                           ("baseline", True, SearchParams(k=10, ef=128, ef_pilot=128))):
    fn = M.baseline_search if base else M.multistage_search
    for B in (1, 13, 100):
        rows_id = rows_d = 0; maxrel = 0.0; keys = set()
        for s in range(0, 128, B):
            q = index.rotate_queries(ds.queries[s:s + B])
            with torch.no_grad():
                a = fn(index.arrays, params, q)
                b = fn(index.arrays, params, M.pad_to_bucket(q)[0])
            b = (b[0][:q.shape[0]], b[1][:q.shape[0]], {k: v[:q.shape[0]] for k, v in b[2].items()})
            rows_id += int((a[0] != b[0]).any(1).sum())
            rows_d += int((a[1].view(torch.int32) != b[1].view(torch.int32)).any(1).sum())
            fin = torch.isfinite(a[1]) & torch.isfinite(b[1])
            rel = ((a[1] - b[1]).abs() / b[1].abs().clamp_min(1e-30))[fin]
            maxrel = max(maxrel, float(rel.max()) if rel.numel() else 0.0)
            keys |= {k for k in a[2] if not torch.equal(a[2][k], b[2][k])}
        print(f"{name} B={B}: rows with other ids {rows_id}, rows with other distance bits {rows_d}, "
              f"max rel dist diff {maxrel:.3g}, stats keys differing {sorted(keys)}", flush=True)
