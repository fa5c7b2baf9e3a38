"""Graph containers — numpy copy of ``repro.core.csr``: fixed-degree padded
adjacency (traversal-friendly)
and the paper's zero-out-degree CSR subgraph (§4.3).

PilotANN keeps excluded nodes *in* the subgraph's id space with out-degree 0
(incoming edges pruned) — no subgraph<->fullgraph id remapping.  We represent
graphs as (n, R) int32 neighbor tables padded with the sentinel id ``n``; an
extra sentinel row at index n makes gathers on sentinel ids self-closing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


SENTINEL_DTYPE = np.int32


@dataclass
class Graph:
    """Fixed-degree adjacency.  neighbors: (n, R) int32, sentinel = n."""
    neighbors: np.ndarray
    n: int

    @property
    def degree_bound(self) -> int:
        return self.neighbors.shape[1]

    @property
    def sentinel(self) -> int:
        return self.n

    def out_degrees(self) -> np.ndarray:
        return (self.neighbors < self.n).sum(axis=1)

    def padded_table(self) -> np.ndarray:
        """(n+1, R) gather table whose last row is all-sentinel."""
        pad = np.full((1, self.degree_bound), self.n, SENTINEL_DTYPE)
        return np.concatenate([self.neighbors.astype(SENTINEL_DTYPE), pad], axis=0)

    def to_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr (n+1,) int64, indices) of the real edges, row by row."""
        deg = self.out_degrees()
        indptr = np.zeros(self.n + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = self.neighbors[self.neighbors < self.n]
        return indptr, indices.astype(SENTINEL_DTYPE)

    @staticmethod
    def from_lists(lists, n: int, R: int) -> "Graph":
        """A graph from per-node neighbour lists, each cut to R and padded
        with the sentinel."""
        nb = np.full((n, R), n, SENTINEL_DTYPE)
        for i, l in enumerate(lists):
            l = list(l)[:R]
            nb[i, :len(l)] = l
        return Graph(nb, n)


def validate_graph(g: Graph) -> None:
    """Asserts the container's invariants: n rows of int32 ids in [0, n],
    no self loop among the real edges."""
    assert g.neighbors.shape[0] == g.n
    assert g.neighbors.dtype == SENTINEL_DTYPE
    assert (g.neighbors >= 0).all() and (g.neighbors <= g.n).all()
    real = g.neighbors < g.n
    rows = np.broadcast_to(np.arange(g.n)[:, None], g.neighbors.shape)
    assert not (real & (g.neighbors == rows)).any(), "self loop"


def subgraph_sample(g: Graph, ratio: float, *, seed: int = 0,
                    method: str = "seed_expand") -> np.ndarray:
    """PilotANN §4.1 sampling: uniform node-wise seed sampling followed by
    1-hop frontier expansion until the target ratio is reached
    (``seed_expand``), or ``uniform`` nodes only.  Returns a boolean (n,)
    membership mask."""
    rng = np.random.default_rng(seed)
    n = g.n
    target = int(round(ratio * n))
    if method == "uniform":
        keep = np.zeros(n, bool)
        keep[rng.choice(n, size=target, replace=False)] = True
        return keep
    if method != "seed_expand":
        raise ValueError(f"unknown sampling method {method!r}")
    seed_count = max(1, target // 2)
    keep = np.zeros(n, bool)
    seeds = rng.choice(n, size=seed_count, replace=False)
    keep[seeds] = True
    frontier = g.neighbors[seeds]
    frontier = frontier[frontier < n]
    frontier = np.unique(frontier)
    frontier = frontier[~keep[frontier]]
    rng.shuffle(frontier)
    room = target - keep.sum()
    keep[frontier[:room]] = True
    # top up with uniform nodes if expansion fell short
    room = target - keep.sum()
    if room > 0:
        rest = np.flatnonzero(~keep)
        keep[rng.choice(rest, size=room, replace=False)] = True
    return keep


def zero_outdegree_subgraph(g: Graph, keep: np.ndarray) -> Graph:
    """Project a graph onto the kept nodes *without remapping ids* (§4.3):
    dropped nodes keep their slot with out-degree zero, and edges pointing at
    dropped nodes are pruned."""
    nb = g.neighbors.copy()
    sent = g.n
    # prune incoming edges to dropped nodes
    dropped_target = (nb < sent) & ~keep[np.clip(nb, 0, sent - 1)]
    nb[dropped_target] = sent
    # zero out-degree for dropped nodes
    nb[~keep] = sent
    # left-compact each row so real neighbours come first
    order = np.argsort(nb == sent, axis=1, kind="stable")
    nb = np.take_along_axis(nb, order, axis=1)
    return Graph(nb, g.n)
