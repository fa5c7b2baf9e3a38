"""Serving driver of the port: batched vector-search serving with the
PilotANN engine — port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --d 64 --batches 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 2000

Builds an index over a synthetic corpus on ``--device`` (default ``cuda``;
without a card it raises unless ``--device cpu`` is given) and runs the
query batches through ``pipeline.pipelined_search``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import IndexConfig, PilotANNIndex, SearchParams
from repro_torch.core.pipeline import pipelined_search
from repro_torch.data import synthetic_vectors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--no-pipeline", action="store_true")
    ap.add_argument("--depth", type=int, default=2,
                    help="batches in flight (DESIGN.md §5)")
    ap.add_argument("--donate", action="store_true",
                    help="donate/recycle the stage-boundary buffers")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ds = synthetic_vectors(args.n, args.d, n_queries=args.batch * args.batches)
    print(f"[serve] building index over {args.n} x {args.d} ...")
    t0 = time.time()
    index = PilotANNIndex(IndexConfig(), ds.vectors, device=args.device)
    print(f"[serve] built on {index.device} in {time.time()-t0:.1f}s; "
          f"{index.memory_report()}")

    params = SearchParams(k=10, ef=args.ef, ef_pilot=args.ef)
    nq = args.batch * args.batches
    rot = index.rotate_queries(ds.queries)
    batches = [rot[i * args.batch:(i + 1) * args.batch]
               for i in range(args.batches)]
    results, dt = pipelined_search(index.arrays, params, batches,
                                   pipelined=not args.no_pipeline,
                                   depth=args.depth, donate=args.donate)
    if not all(np.all(r[0][:, 0] >= 0) for r in results):
        raise RuntimeError("a query came back without a neighbour")
    print(f"[serve] {args.batches} batches x {args.batch} queries in "
          f"{dt:.3f}s -> {nq / dt:,.0f} QPS "
          f"(pipelined={not args.no_pipeline}, depth={args.depth}, "
          f"donate={args.donate})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
