"""Deterministic synthetic vector corpora — numpy copy of the vector half of
``repro.data.pipeline`` (the port imports nothing of the JAX package).

Distribution-matched synthetic corpora for the ANNS engine: mixtures of
anisotropic Gaussian clusters with heavy-tailed cluster sizes plus a
low-rank global component, which reproduces the spectral decay that makes
SVD-based primary/residual splits meaningful (real embedding sets like
DEEP/LAION concentrate most distance mass in the top dims).  The same seed
gives the same arrays as the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# Vector corpora for the ANNS engine
# ---------------------------------------------------------------------------

@dataclass
class VectorDataset:
    vectors: np.ndarray
    queries: np.ndarray
    name: str


def synthetic_vectors(n: int, d: int, *, n_queries: int = 1024,
                      n_clusters: Optional[int] = None, seed: int = 0,
                      spectral_decay: float = 0.7,
                      cluster_scale: float = 1.0,
                      name: str = "synthetic") -> VectorDataset:
    """Embedding-like corpus: anisotropic clustered + low-rank structure."""
    rng = np.random.default_rng(seed)
    n_clusters = n_clusters or max(8, int(np.sqrt(n) / 8))
    # per-dim scales with power-law decay (what makes SVD primary dims work)
    scales = (np.arange(1, d + 1, dtype=np.float32) ** (-spectral_decay))
    scales /= np.sqrt((scales ** 2).mean())
    # heavy-tailed cluster sizes, capped so no micro-cluster is unreachable
    sizes = np.minimum(rng.zipf(1.5, size=n_clusters), 50).astype(np.float64)
    probs = sizes / sizes.sum()
    assign = rng.choice(n_clusters, size=n, p=probs)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * scales * cluster_scale
    x = rng.normal(size=(n, d)).astype(np.float32) * scales * 0.6
    x += centers[assign]
    # ~30% broad background mass: the inter-cluster 'bridges' that make real
    # embedding corpora graph-navigable (HNSW relies on this; an all-islands
    # mixture is adversarial in a way DEEP/LAION are not)
    bg = rng.random(n) < 0.3
    x[bg] = rng.normal(size=(int(bg.sum()), d)).astype(np.float32) * scales * 1.4
    # random rotation so the structure is not axis-aligned
    qmat, _ = np.linalg.qr(rng.normal(size=(d, d)))
    x = (x @ qmat.astype(np.float32))
    # queries: perturbed corpus points (realistic: queries near the manifold)
    qi = rng.choice(n, size=n_queries, replace=False)
    queries = x[qi] + rng.normal(size=(n_queries, d)).astype(np.float32) * \
        (0.05 * np.linalg.norm(x, axis=1).mean() / np.sqrt(d))
    return VectorDataset(vectors=x, queries=queries.astype(np.float32), name=name)


DATASET_PRESETS = {
    # name: (d, spectral_decay) — shaped after the paper's Table 3 datasets
    "deep": (96, 0.6),
    "t2i": (200, 0.5),
    "wiki": (768, 0.8),
    "laion": (768, 0.7),
}


def preset_dataset(name: str, n: int, *, n_queries: int = 1024,
                   seed: int = 0) -> VectorDataset:
    d, decay = DATASET_PRESETS[name]
    return synthetic_vectors(n, d, n_queries=n_queries, seed=seed,
                             spectral_decay=decay, name=f"{name}-{n}")
