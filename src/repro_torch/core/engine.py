"""Single-host PilotANN engine: index build + search entry points — port of
``repro.core.engine``.

Build (offline, identical to the reference — same seed, same arrays):
SVD rotation → full graph → sampled subgraph rebuilt with the same
construction algorithm (paper §4.1/§4.3) → FES clusters → coarse layer.
The graphs are built on the host (numpy; ``build_method`` exact, clustered
or auto) or, with ``build_method="nn_descent"``, by the device build
(``core/device_build``) on the index's own device; the coarse layer always
uses the host's ``auto``.  ``build_seconds`` keeps the wall seconds by
part.  The stage-① ("pilot") payloads live in a *compact* id space.

Search (online, PyTorch): ``multistage_search`` / ``baseline_search`` run
eagerly on the index's device.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no card and no explicit ``"cpu"`` they
raise — there is no silent CPU fallback.

``arrays_from_numpy`` / ``PilotANNIndex.from_arrays`` carry an index built by
the reference (its ``arrays`` dict and ``reducer.V``) into the port, so both
packages can be run on identical index state.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import csr, fes, graph_build, multistage, quant, svd
from repro_torch.core.devices import resolve_device
from repro_torch.core.multistage import SearchParams


def arrays_from_numpy(arrays: Dict[str, np.ndarray],
                      device=None) -> Dict[str, torch.Tensor]:
    """Copy a built ``arrays`` dict (numpy, or anything ``np.asarray``
    takes — e.g. the reference's jax arrays) onto ``device``, keeping every
    key and dtype.  Quantized pilot tables are refused (ROADMAP A5)."""
    dev = resolve_device(device)
    for k in ("primary_scale", "primary_codebook", "fes_entries_scale",
              "fes_entries_codebook"):
        if k in arrays:
            raise NotImplementedError(f"quantized pilot array {k!r}: ROADMAP A5")
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        if not a.flags.writeable:          # e.g. a view of a jax array
            a = a.copy()
        if k in ("primary", "fes_entries") and a.dtype != np.float32:
            raise NotImplementedError(
                f"{k} stored as {a.dtype}: only float32 pilots are ported "
                f"(ROADMAP A5)")
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


@dataclass
class IndexConfig:
    """Build-time index knobs (the reference's, minus the jit-cache bound;
    ``ResidencyPlanner`` and the quantized ``pilot_dtype`` values wait for
    ROADMAP A5)."""
    R: int = 32                  # graph degree bound
    sample_ratio: float = 0.25   # subgraph node ratio (paper Table 3)
    svd_ratio: float = 0.5       # primary-dims ratio (paper Table 3)
    n_entry: int = 8192          # FES entry pool size
    fes_clusters: int = 32       # r (warp width in the paper)
    coarse_ratio: float = 1.0 / 64  # entry-layer size (HNSW-hierarchy analogue)
    # exact | clustered | auto (host) | nn_descent (on the index's device)
    build_method: str = "auto"
    seed: int = 0
    pilot_dtype: str = "float32"
    # pilot-graph id width: auto (int16 when the compact id space fits,
    # else int32) | int16 | int32
    pilot_id_dtype: str = "auto"
    # optional hard budget for the stage-① resident bytes
    pilot_budget_bytes: Optional[int] = None


class PilotANNIndex:
    """Holds the numpy build artefacts and the device tensors of the search
    stages."""

    def __init__(self, cfg: IndexConfig, vectors: np.ndarray, device=None):
        quant.check_pilot_dtype(cfg.pilot_dtype)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n, self.d = vectors.shape
        n = self.n
        secs = self.build_seconds = {"full_graph": {}, "subgraph": {}}
        t0 = time.perf_counter()

        # --- SVD rotation & split (§4.1) ---
        self.reducer = svd.svd_fit(vectors, cfg.svd_ratio, seed=cfg.seed)
        rot = self.reducer.rotate(vectors)                     # (n, d)
        dp = self.reducer.d_primary
        secs["svd"] = time.perf_counter() - t0

        # --- full graph ---
        self.full_graph = graph_build.build_graph(
            rot, cfg.R, method=cfg.build_method, seed=cfg.seed,
            device=self.device, timings=secs["full_graph"])

        # --- sampled subgraph, rebuilt with the same construction algo ---
        keep = csr.subgraph_sample(self.full_graph, cfg.sample_ratio,
                                   seed=cfg.seed)
        keep_ids = np.flatnonzero(keep)
        nk = len(keep_ids)
        if nk > 2:
            sub_compact = graph_build.build_graph(
                rot[keep_ids], cfg.R, method=cfg.build_method,
                seed=cfg.seed + 1, device=self.device,
                timings=secs["subgraph"])
            # remap compacted ids -> original ids; zero-out-degree CSR (§4.3)
            nb = sub_compact.neighbors
            remapped = np.where(nb < len(keep_ids),
                                keep_ids[np.clip(nb, 0, len(keep_ids) - 1)], n)
            sub_nb = np.full((n, cfg.R), n, np.int32)
            sub_nb[keep_ids] = remapped
            self.sub_graph = csr.Graph(sub_nb.astype(np.int32), n)
        else:
            self.sub_graph = csr.zero_outdegree_subgraph(self.full_graph, keep)
        self.keep = keep
        self.keep_ids = keep_ids
        self.n_pilot = nk

        # --- compact pilot id space: full id -> pilot id (dropped nodes and
        # the full sentinel map to the pilot sentinel nk)
        full_to_pilot = np.full(n + 1, nk, np.int32)
        full_to_pilot[keep_ids] = np.arange(nk, dtype=np.int32)
        id_dt = self._resolve_id_dtype(cfg.pilot_id_dtype, nk)
        pilot_nb = full_to_pilot[self.sub_graph.padded_table()[keep_ids]]
        pilot_nb = np.concatenate(
            [pilot_nb, np.full((1, cfg.R), nk, np.int32)], axis=0)
        pilot_primary = np.concatenate(
            [rot[keep_ids][:, :dp], np.zeros((1, dp), np.float32)], axis=0)

        # --- FES (entries sampled from subgraph members; primary dims).
        # fes_index keeps *full*-corpus entry ids; the device table carries
        # compact pilot ids for stage ① ---
        ne = min(cfg.n_entry, nk)
        t0 = time.perf_counter()
        self.fes_index = fes.build_fes(
            rot[:, :dp], keep_ids, r=cfg.fes_clusters, n_entry=cfg.n_entry,
            seed=cfg.seed,
            max_capacity=fes.fes_capacity_cap(ne, cfg.fes_clusters))
        secs["fes"] = time.perf_counter() - t0

        # --- coarse entry layer (baseline and the "- FES" ablation) ---
        t0 = time.perf_counter()
        rng = np.random.default_rng(cfg.seed + 7)
        m = min(n, max(64, int(n * cfg.coarse_ratio)))
        coarse_ids = np.sort(rng.choice(n, size=m, replace=False))
        coarse_graph = graph_build.build_graph(rot[coarse_ids],
                                               min(cfg.R, 16), method="auto",
                                               seed=cfg.seed + 7)
        self.coarse_ids = coarse_ids
        self.coarse_graph = coarse_graph
        secs["coarse"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # --- device tensors (same keys, dtypes and values as the
        # reference's arrays dict) ---
        zrow = lambda a: np.concatenate([a, np.zeros((1, a.shape[1]), a.dtype)], 0)
        self.arrays = arrays_from_numpy({
            "full_neighbors": self.full_graph.padded_table(),
            "sub_neighbors": pilot_nb.astype(id_dt),
            "pilot_to_full": np.concatenate([keep_ids, [n]]).astype(np.int32),
            "rot_vecs": zrow(rot),
            "residual": zrow(rot[:, dp:]),
            "fes_centroids": self.fes_index.centroids,
            "fes_entry_ids": full_to_pilot[self.fes_index.entry_ids],
            "fes_valid": self.fes_index.valid,
            "default_entries": np.array([graph_build.medoid(rot)], np.int32),
            "pilot_default_entry": np.array(
                [graph_build.medoid(rot[keep_ids])], np.int32),
            "coarse_neighbors": coarse_graph.padded_table(),
            "coarse_vecs": zrow(rot[coarse_ids]),
            "coarse_ids": np.concatenate([coarse_ids, [n]]).astype(np.int32),
            "coarse_pilot_ids": full_to_pilot[np.concatenate([coarse_ids, [n]])],
            "coarse_entry": np.array(
                [graph_build.medoid(rot[coarse_ids])], np.int32),
            "primary": pilot_primary.astype(np.float32),
            "fes_entries": self.fes_index.entries.astype(np.float32),
        }, self.device)
        secs["tables"] = time.perf_counter() - t0

        if cfg.pilot_budget_bytes is not None:
            got = self.memory_report()["pilot_bytes"]
            if got > cfg.pilot_budget_bytes:
                raise ValueError(
                    f"pilot payload is {got} B, over the "
                    f"pilot_budget_bytes={cfg.pilot_budget_bytes} budget; "
                    f"reduce n_entry / sample_ratio / svd_ratio")

    @classmethod
    def from_arrays(cls, cfg: IndexConfig, arrays: Dict[str, np.ndarray],
                    V: np.ndarray, d_primary: int, device=None
                    ) -> "PilotANNIndex":
        """An index over already-built state: the reference's ``arrays``
        dict (the key list of ``multistage_search``) and its SVD rotation
        ``reducer.V``.  No build artefacts besides those."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.arrays = arrays_from_numpy(arrays, self.device)
        self.reducer = svd.SVDReducer(
            V=np.ascontiguousarray(np.asarray(V), np.float32),
            d_primary=int(d_primary), explained=None)
        self.n = self.arrays["rot_vecs"].shape[0] - 1
        self.d = self.arrays["rot_vecs"].shape[1]
        self.n_pilot = self.arrays["pilot_to_full"].shape[0] - 1
        return self

    # ------------------------------------------------------------------
    @staticmethod
    def _resolve_id_dtype(pilot_id_dtype: str, nk: int):
        i16_max = np.iinfo(np.int16).max
        if pilot_id_dtype == "int32":
            return np.int32
        if pilot_id_dtype == "int16":
            if nk + 1 > i16_max:
                raise ValueError(f"pilot id space {nk + 1} overflows int16")
            return np.int16
        if pilot_id_dtype == "auto":
            return np.int16 if nk + 1 <= i16_max else np.int32
        raise ValueError(f"pilot_id_dtype must be auto|int16|int32, "
                         f"got {pilot_id_dtype!r}")

    # ------------------------------------------------------------------
    def rotate_queries(self, queries) -> torch.Tensor:
        """Rotate raw queries into the index's SVD basis, on the index's
        device (numpy rotation, as in the reference)."""
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().cpu().numpy()
        return torch.from_numpy(self.reducer.rotate(queries)).to(self.device)

    def _run(self, queries, params: SearchParams, baseline: bool, rotated: bool
             ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
        q = (torch.as_tensor(queries, dtype=torch.float32).to(self.device)
             if rotated else self.rotate_queries(queries))
        fn = multistage.baseline_search if baseline else multistage.multistage_search
        with torch.no_grad():
            ids, dists, stats = fn(self.arrays, params, q)
        return (ids.cpu().numpy(), dists.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in stats.items()})

    def search(self, queries, params: SearchParams, *, rotated: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
        """Multi-stage search; returns numpy (ids (B, k), dists (B, k),
        stats) like the reference."""
        return self._run(queries, params, False, rotated)

    def search_baseline(self, queries, params: SearchParams, *,
                        rotated: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
        return self._run(queries, params, True, rotated)

    # ------------------------------------------------------------------
    def memory_report(self) -> Dict:
        """Bytes by residence class (paper Table 3 accounting).
        ``pilot_bytes`` is the stage-① payload: compact subgraph ids +
        primary vectors + FES entry buckets."""
        A = self.arrays
        nbytes = lambda k: (int(A[k].numel() * A[k].element_size())
                            if k in A else 0)
        pilot_graph = nbytes("sub_neighbors")
        pilot_vec = nbytes("primary")
        pilot_fes = nbytes("fes_entries")
        pilot = pilot_graph + pilot_vec + pilot_fes
        full = (nbytes("full_neighbors") + nbytes("rot_vecs") +
                nbytes("residual"))
        return {"pilot_bytes": pilot, "full_bytes": full,
                "ratio": float(full / max(pilot, 1)),
                "pilot_dtype": self.cfg.pilot_dtype,
                "pilot_id_dtype": str(A["sub_neighbors"].dtype).replace("torch.", ""),
                "pilot_graph_bytes": pilot_graph,
                "pilot_vec_bytes": pilot_vec,
                "pilot_fes_bytes": pilot_fes,
                "pilot_nodes": self.n_pilot,
                "d_primary": self.reducer.d_primary,
                "device_bytes": sum(nbytes(k) for k in A)}


def recall_at_k(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """recall@k = |retrieved_k ∩ groundtruth_k| / k, averaged over queries."""
    hits = 0
    for row, g in zip(ids[:, :k], gt[:, :k]):
        hits += len(set(row.tolist()) & set(g.tolist()))
    return hits / (len(ids) * k)


def brute_force_topk(vectors: np.ndarray, queries: np.ndarray, k: int
                     ) -> np.ndarray:
    ids, _ = graph_build.brute_knn(vectors, k, queries=queries)
    return ids
