"""Semantic cache (GPTCache-style — one of the paper's motivating
workloads): short-circuit a request when a near-identical query was already
answered — port of ``repro.serving.semantic_cache``.

The cache is a mutable PilotANN index over past query embeddings
(``core/segments.SegmentedIndex``, on the cache's device): each insert is
an incremental repair into a delta segment, bounded by the delta's size,
and the one heavyweight operation, folding the deltas into a fresh base,
waits for ``maintain()``, which the serving loop calls on idle pump cycles
(``ThroughputEngine.pump``).  Every lookup increments exactly one of the
hit and miss counters, against the index as it stands at lookup time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from repro_torch.core.engine import IndexConfig
from repro_torch.core.multistage import SearchParams
from repro_torch.core.segments import SegmentedIndex, UpdateParams

# Below this many inserts there is nothing worth building a graph over; the
# cache stays cold (misses).
MIN_BUILD = 64


@dataclass
class SemanticCache:
    dim: int
    threshold: float = 0.25          # max squared distance for a hit
    rebuild_every: int = 256         # compaction cadence (deferred to maintain)
    index_cfg: IndexConfig = field(default_factory=lambda: IndexConfig(
        R=16, sample_ratio=0.5, svd_ratio=0.5, n_entry=512))
    # cheap repair: while a delta stays under brute_threshold its lookups
    # are exact whatever the graph, so base occluders would buy nothing
    update_params: UpdateParams = field(default_factory=lambda: UpdateParams(
        delta_capacity=64, repair_ef=32, repair_knn=8,
        use_base_occluders=False))
    # where the cache's index lives (None: cuda, as every entry point)
    device: Any = None

    _values: List[Any] = field(default_factory=list)   # gid -> value
    _staged: List[np.ndarray] = field(default_factory=list)  # pre-MIN_BUILD
    _index: Optional[SegmentedIndex] = None
    _inserts_since_compact: int = 0
    hits: int = 0
    misses: int = 0

    def lookup(self, emb: np.ndarray) -> Optional[Any]:
        if self._index is None:
            self.misses += 1
            return None
        params = SearchParams(k=1, ef=32, ef_pilot=32)
        gids, dists, _ = self._index.search(emb[None, :], params)
        if gids[0, 0] >= 0 and dists[0, 0] <= self.threshold:
            self.hits += 1
            return self._values[int(gids[0, 0])]
        self.misses += 1
        return None

    def insert(self, emb: np.ndarray, value: Any) -> None:
        """Record one (embedding, value) pair: a staging append (cold
        cache), the one-time ``MIN_BUILD``-row base build, or a single-row
        incremental repair into the delta segment — never a full rebuild
        (that waits for ``maintain()``)."""
        emb = np.asarray(emb, np.float32)
        self._values.append(value)
        if self._index is None:
            self._staged.append(emb)
            if len(self._staged) >= MIN_BUILD:
                self._index = SegmentedIndex(self.index_cfg,
                                             np.stack(self._staged),
                                             self.update_params,
                                             device=self.device)
                self._staged = []
            return
        self._index.insert(emb[None, :])
        self._inserts_since_compact += 1

    @property
    def maintenance_pending(self) -> bool:
        """True when a deferred compaction is due (polled by the serving
        loop on idle pump cycles)."""
        return (self._index is not None
                and self._inserts_since_compact >= self.rebuild_every)

    def maintain(self, budget: int = 1) -> bool:
        """Run at most one deferred maintenance step (fold the deltas into a
        fresh base once ``rebuild_every`` inserts have accumulated).
        Returns True if work was done."""
        if not self.maintenance_pending or budget <= 0:
            return False
        self._index.compact()
        self._inserts_since_compact = 0
        return True

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
