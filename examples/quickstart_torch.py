"""Quickstart for the PyTorch/CUDA port: build a PilotANN index, search it,
compare with the baseline.

  PYTHONPATH=src python examples/quickstart_torch.py               # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # no card

Imports only ``repro_torch`` (torch and numpy).  Without ``--device`` the
index lives on the CUDA card and the search runs its kernels; ``cpu`` runs
every kernel's plain PyTorch version.
"""

import argparse
import time

from repro_torch.core import (IndexConfig, PilotANNIndex, SearchParams,
                              brute_force_topk, recall_at_k)
from repro_torch.data import synthetic_vectors


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=10000)
    args = ap.parse_args()

    # 1. a synthetic embedding corpus (spectrally decaying, clustered, like
    #    real DEEP/LAION embeddings)
    ds = synthetic_vectors(n=args.n, d=64, n_queries=256, seed=0)

    # 2. build: SVD rotation -> navigable graph -> sampled subgraph -> FES
    t0 = time.time()
    index = PilotANNIndex(IndexConfig(R=24, sample_ratio=0.25, svd_ratio=0.5,
                                      n_entry=2048), ds.vectors,
                          device=args.device)
    print(f"built index over {ds.vectors.shape} on {index.device} in "
          f"{time.time() - t0:.1f}s")
    print("memory:", index.memory_report())

    # 3. search: multi-stage (pilot -> refine -> final) vs plain greedy
    gt = brute_force_topk(ds.vectors, ds.queries, 10)
    params = SearchParams(k=10, ef=64, ef_pilot=64)
    ids_b, _, st_b = index.search_baseline(ds.queries, params)
    ids_m, _, st_m = index.search(ds.queries, params)
    print(f"baseline : recall@10={recall_at_k(ids_b, gt, 10):.3f} "
          f"cpu_dist={st_b['total_cpu_dist'].mean():.0f}")
    print(f"pilotann : recall@10={recall_at_k(ids_m, gt, 10):.3f} "
          f"cpu_dist={st_m['total_cpu_dist'].mean():.0f} "
          f"(pilot stage offloads {st_m['pilot_dist'].mean():.0f} calcs)")


if __name__ == "__main__":
    main()
