"""The benchmark's own vector generator: a frozen copy, in NumPy, of
``repro_torch.data.synthetic_vectors`` / ``preset_dataset``.

It is the yardstick's copy: the program may change its generator, and the
benchmark keeps making the same corpora from the same seed.  A corpus is a
mixture of anisotropic Gaussian clusters with heavy-tailed sizes, ~30%
broad background mass and a random rotation; the per-dimension scales decay
as a power law, which is what makes an SVD split into primary and residual
dimensions work on real embeddings.  Queries are corpus points plus a small
perturbation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_vectors(n: int, d: int, *, n_queries: int, seed: int,
                      spectral_decay: float
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(vectors (n, d), queries (n_queries, d)), float32, from ``seed``."""
    rng = np.random.default_rng(seed)
    n_clusters = max(8, int(np.sqrt(n) / 8))
    scales = (np.arange(1, d + 1, dtype=np.float32) ** (-spectral_decay))
    scales /= np.sqrt((scales ** 2).mean())
    sizes = np.minimum(rng.zipf(1.5, size=n_clusters), 50).astype(np.float64)
    probs = sizes / sizes.sum()
    assign = rng.choice(n_clusters, size=n, p=probs)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * scales
    x = rng.normal(size=(n, d)).astype(np.float32) * scales * 0.6
    x += centers[assign]
    bg = rng.random(n) < 0.3
    x[bg] = (rng.normal(size=(int(bg.sum()), d)).astype(np.float32) * scales
             * 1.4)
    qmat, _ = np.linalg.qr(rng.normal(size=(d, d)))
    x = x @ qmat.astype(np.float32)
    qi = rng.choice(n, size=n_queries, replace=False)
    queries = x[qi] + rng.normal(size=(n_queries, d)).astype(np.float32) * \
        (0.05 * np.linalg.norm(x, axis=1).mean() / np.sqrt(d))
    return x, queries.astype(np.float32)


def make_dataset(data: dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A configuration's ``data`` block (``n``, ``d``, ``n_queries``,
    ``spectral_decay``, optional ``n_insert``) made from ``seed``: ``n +
    n_insert`` rows, the index built over the first ``n`` and the last
    ``n_insert`` held back for a driver to insert in order.  Rows are drawn
    independently of one another, so the held-back rows are a sample of the
    same corpus; without ``n_insert`` the bytes are those of ``n`` rows."""
    n = int(data["n"]) + int(data.get("n_insert", 0))
    return synthetic_vectors(n, int(data["d"]),
                             n_queries=int(data["n_queries"]), seed=seed,
                             spectral_decay=float(data["spectral_decay"]))
