"""Deterministic synthetic data — a numpy copy of ``repro.data.pipeline``
(the port imports nothing of the JAX package).

Token pipeline: seeded per (step, host) so every host generates exactly its
own shard — no central dispenser, restart-safe (resuming at step k
regenerates the identical batch).  Data is a pure function of (seed, step),
the same arrays as the reference's, bit for bit.

Vector corpora: distribution-matched synthetic corpora for the ANNS
engine: mixtures of anisotropic Gaussian clusters with heavy-tailed cluster
sizes plus a low-rank global component, which reproduces the spectral decay
that makes SVD-based primary/residual splits meaningful (real embedding
sets like DEEP/LAION concentrate most distance mass in the top dims).  The
same seed gives the same arrays as the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The host's shard of the global batch for ``step`` (pure function):
        ``tokens`` and ``labels`` (the tokens shifted by one), int32."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        # zipf-ish marginal over the vocab + markov-ish repetition structure
        base = rng.zipf(1.3, size=(self.host_batch, self.seq_len + 1))
        tokens = (base % (self.vocab_size - 2)) + 1
        rep = rng.random((self.host_batch, self.seq_len + 1)) < 0.15
        tokens[:, 1:][rep[:, 1:]] = tokens[:, :-1][rep[:, 1:]]
        tokens = tokens.astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_token_pipeline(cfg, shape, *, n_hosts: int = 1, host_id: int = 0,
                        seed: int = 0) -> TokenPipeline:
    return TokenPipeline(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                         global_batch=shape.global_batch, n_hosts=n_hosts,
                         host_id=host_id, seed=seed)


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
