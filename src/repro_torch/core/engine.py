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

Search (online, PyTorch): ``search`` / ``search_baseline`` pad each batch
to the ``batch_buckets`` ladder and run ``multistage_program`` /
``baseline_program`` through a compiled call cached per (bucket, params,
baseline) — CUDA graphs on the card, a plain callable on the CPU
(``core/compiled.py``), the reference's jit cache with its LRU bound
(``IndexConfig.jit_cache_capacity``), ``warmup``, ``compile_count`` and
``cache_stats``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit ``"cpu"`` they raise — there
is no silent CPU fallback.

The stage-① vector tables (primary rows and FES buckets) may be quantized
(``IndexConfig.pilot_dtype``: float32, bfloat16, int8, int4 or pq,
``core/quant.py``); the index keeps the host fp32 pilot rows, so
``set_pilot_dtype`` re-encodes them without a rebuild, and
``ResidencyPlanner`` solves the pilot knobs for a byte budget.

``arrays_from_numpy`` / ``PilotANNIndex.from_arrays`` carry an index built by
the reference (its ``arrays`` dict and ``reducer.V``) into the port, so both
packages can be run on identical index state.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (compiled, csr, fes, graph_build, multistage,
                              quant, svd)
from repro_torch.core.devices import resolve_device
from repro_torch.core.multistage import (BATCH_BUCKETS, SearchParams,
                                         pad_to_bucket)
from repro_torch.runtime import trace


# stage-① side arrays of the quantized encodings (scale rows, codebooks)
SIDE_KEYS = ("primary_scale", "fes_entries_scale", "primary_codebook",
             "fes_entries_codebook")


def _to_tensor(a) -> torch.Tensor:
    """A host array as a CPU tensor of the same dtype and bits.  bf16
    arrays (the reference's ``ml_dtypes`` type, which ``torch.from_numpy``
    refuses) cross as their 16-bit patterns."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                                ).view(torch.bfloat16)
    if not a.flags.writeable:              # e.g. a view of a jax array
        a = a.copy()
    return torch.from_numpy(np.ascontiguousarray(a))


def arrays_from_numpy(arrays: Dict[str, np.ndarray],
                      device=None) -> Dict[str, torch.Tensor]:
    """Copy a built ``arrays`` dict (numpy, torch, or anything
    ``np.asarray`` takes — e.g. the reference's jax arrays, quantized pilot
    tables and their side arrays included) onto ``device``, keeping every
    key, dtype and bit."""
    dev = resolve_device(device)
    return {k: _to_tensor(a).to(dev) for k, a in arrays.items()}


@dataclass
class IndexConfig:
    """Build-time index knobs (the reference's)."""
    R: int = 32                  # graph degree bound
    sample_ratio: float = 0.25   # subgraph node ratio (paper Table 3)
    svd_ratio: float = 0.5       # primary-dims ratio (paper Table 3)
    n_entry: int = 8192          # FES entry pool size
    fes_clusters: int = 32       # r (warp width in the paper)
    coarse_ratio: float = 1.0 / 64  # entry-layer size (HNSW-hierarchy analogue)
    # exact | clustered | auto (host) | nn_descent (on the index's device)
    build_method: str = "auto"
    seed: int = 0
    # stage-① payload encoding: float32 | bfloat16 | int8 | int4 | pq
    # (core/quant.py); stage ② then re-scores the pilot beam exactly
    pilot_dtype: str = "float32"
    # pilot-graph id width: auto (int16 when the compact id space fits,
    # else int32) | int16 | int32
    pilot_id_dtype: str = "auto"
    # optional hard budget for the stage-① resident bytes
    pilot_budget_bytes: Optional[int] = None
    # LRU bound on the compiled-search cache, keyed (bucket, params,
    # baseline); evictions are counted in ``PilotANNIndex.jit_evictions`` /
    # ``cache_stats()``.  On the card each entry holds its graphs' memory.
    jit_cache_capacity: int = 32


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
        # fp32 primary rows of the kept nodes (+ zero sentinel row), kept on
        # the host so that set_pilot_dtype can re-encode without a rebuild
        self._pilot_primary = np.concatenate(
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
        }, self.device)
        self.arrays.update(self._quantized_pilot_arrays(cfg.pilot_dtype))
        secs["tables"] = time.perf_counter() - t0
        self._init_search_cache()

        if cfg.pilot_budget_bytes is not None:
            got = self.memory_report()["pilot_bytes"]
            if got > cfg.pilot_budget_bytes:
                raise ValueError(
                    f"pilot payload is {got} B, over the "
                    f"pilot_budget_bytes={cfg.pilot_budget_bytes} budget; "
                    f"shrink it via ResidencyPlanner(n, d, R={cfg.R}, "
                    f"n_entry={cfg.n_entry}).plan(budget).to_config(), or "
                    f"reduce n_entry / raise fes_clusters (FES buckets), "
                    f"or lower sample_ratio/svd_ratio/pilot_dtype directly")

    @classmethod
    def from_arrays(cls, cfg: IndexConfig, arrays: Dict[str, np.ndarray],
                    V: np.ndarray, d_primary: int, device=None
                    ) -> "PilotANNIndex":
        """An index over already-built state: the reference's ``arrays``
        dict (the key list of ``multistage_search``; quantized pilot tables
        are taken as they are) and its SVD rotation ``reducer.V``.  No
        build artefacts besides those, so ``set_pilot_dtype`` raises."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.cfg = cfg
        self._pilot_primary = None
        self.arrays = arrays_from_numpy(arrays, self.device)
        self.reducer = svd.SVDReducer(
            V=np.ascontiguousarray(np.asarray(V), np.float32),
            d_primary=int(d_primary), explained=None)
        self.n = self.arrays["rot_vecs"].shape[0] - 1
        self.d = self.arrays["rot_vecs"].shape[1]
        self.n_pilot = self.arrays["pilot_to_full"].shape[0] - 1
        self._init_search_cache()
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

    def _quantized_pilot_arrays(self, pilot_dtype: str
                                ) -> Dict[str, torch.Tensor]:
        """Encode the stage-① vector tables (primary rows + FES buckets) on
        the host and move them to the index's device: the scale rows
        (int8/int4) or codebooks (pq) ride along as side arrays."""
        pdata, pside = quant.quantize(self._pilot_primary, pilot_dtype)
        fdata, fside = quant.quantize(self.fes_index.entries, pilot_dtype)
        out = {"primary": pdata, "fes_entries": fdata}
        if pside is not None:
            kind = "codebook" if pilot_dtype == "pq" else "scale"
            out[f"primary_{kind}"] = pside
            out[f"fes_entries_{kind}"] = fside
        return arrays_from_numpy(out, self.device)

    def set_pilot_dtype(self, pilot_dtype: str) -> "PilotANNIndex":
        """Re-encode the stage-① payloads in place (no graph or SVD
        rebuild) and drop the compiled searches, whose graphs hold the old
        tables.  Re-checks ``pilot_budget_bytes``: on a violation the
        previous encoding is restored and ValueError raised.  Returns
        self."""
        quant.check_pilot_dtype(pilot_dtype)
        if self._pilot_primary is None:
            raise ValueError("set_pilot_dtype needs the host fp32 pilot rows, "
                             "which an index made by from_arrays does not "
                             "keep")
        prev = self.cfg.pilot_dtype
        self._apply_pilot_dtype(pilot_dtype)
        budget = self.cfg.pilot_budget_bytes
        if budget is not None:
            got = self.memory_report()["pilot_bytes"]
            if got > budget:
                self._apply_pilot_dtype(prev)
                raise ValueError(
                    f"set_pilot_dtype({pilot_dtype!r}) would grow the pilot "
                    f"payload to {got} B, over pilot_budget_bytes={budget}; "
                    f"encoding left at {prev!r}")
        return self

    def _apply_pilot_dtype(self, pilot_dtype: str) -> None:
        self.cfg = dataclasses.replace(self.cfg, pilot_dtype=pilot_dtype)
        for k in SIDE_KEYS:
            self.arrays.pop(k, None)
        self.arrays.update(self._quantized_pilot_arrays(pilot_dtype))
        self._compiled_fns()            # drops the searches compiled before

    # ------------------------------------------------------------------
    def rotate_queries(self, queries) -> torch.Tensor:
        """Rotate raw queries into the index's SVD basis, on the index's
        device (numpy rotation, as in the reference)."""
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().cpu().numpy()
        return torch.from_numpy(self.reducer.rotate(queries)).to(self.device)

    def _init_search_cache(self) -> None:
        # compiled searches keyed on (bucket, params, baseline): client
        # batches are padded to a small fixed ladder of sizes, so ragged
        # traffic compiles at most len(buckets) programs per params key
        self.batch_buckets: Tuple[int, ...] = BATCH_BUCKETS
        self._search_fns: "OrderedDict" = OrderedDict()
        self._jit_evictions = 0
        self._arrays_seen = None

    def _compiled_fns(self) -> "OrderedDict":
        """The compiled-search cache, first emptied if a tensor of
        ``self.arrays`` was replaced since it was filled (a captured graph
        holds the old tensors' addresses; ``set_pilot_dtype`` replaces
        them).  The reference's jit takes ``arrays`` as arguments and has no
        such drop; it counts in neither ``jit_evictions`` nor
        ``compile_count``."""
        seen = [(k, id(v)) for k, v in self.arrays.items()]
        if seen != self._arrays_seen:
            self._search_fns.clear()
            self._arrays_seen = seen
        return self._search_fns

    def _get_fn(self, params: SearchParams, baseline: bool, bucket: int):
        fns = self._compiled_fns()
        key = (bucket, dataclasses.astuple(params), baseline)
        if key in fns:
            fns.move_to_end(key)                        # LRU touch
            return fns[key]
        while fns and len(fns) >= max(1, self.cfg.jit_cache_capacity):
            fns.popitem(last=False)                     # evict least-recent
            self._jit_evictions += 1
        program = (multistage.baseline_program if baseline
                   else multistage.multistage_program)
        q = torch.zeros((bucket, self.d), dtype=torch.float32,
                        device=self.device)
        fns[key] = compiled.compile_program(
            partial(program, dict(self.arrays), params), (q,))
        return fns[key]

    @property
    def jit_evictions(self) -> int:
        """Compiled searches evicted from the LRU-bounded cache so far."""
        return self._jit_evictions

    def cache_stats(self) -> Dict[str, int]:
        """Compiled-search cache observables: live programs, LRU capacity,
        lifetime eviction count."""
        return {"cached_executables": len(self._compiled_fns()),
                "capacity": self.cfg.jit_cache_capacity,
                "jit_evictions": self._jit_evictions}

    def compile_count(self, params: Optional[SearchParams] = None,
                      baseline: Optional[bool] = None) -> int:
        """Number of cached compiled searches, optionally filtered by
        params / baseline-ness — the bounded-recompilation observable the
        bucket ladder exists to cap."""
        pk = None if params is None else dataclasses.astuple(params)
        return sum(1 for (_, p, b) in self._compiled_fns()
                   if (pk is None or p == pk)
                   and (baseline is None or b == baseline))

    def warmup(self, params: SearchParams, *, baseline: bool = False,
               buckets: Optional[Tuple[int, ...]] = None) -> int:
        """Compile (on the card: capture) one search per bucket, outside any
        latency-sensitive window; returns the number of buckets warmed."""
        buckets = buckets or self.batch_buckets
        for b in buckets:
            q = torch.zeros((b, self.d), dtype=torch.float32,
                            device=self.device)
            self._get_fn(params, baseline, b)(q)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(buckets)

    def _run_bucketed(self, queries, params: SearchParams, baseline: bool,
                      rotated: bool
                      ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
        q = (torch.as_tensor(queries, dtype=torch.float32).to(self.device)
             if rotated else self.rotate_queries(queries))
        # pad ragged client batches to the bucket ladder, so that the cache
        # holds a small fixed set of shapes; results slice back
        q, B = pad_to_bucket(q, self.batch_buckets)
        ids, dists, stats = self._get_fn(params, baseline, q.shape[0])(q)
        with trace.span("readback"):
            return (ids[:B].cpu().numpy(), dists[:B].cpu().numpy(),
                    {k: v[:B].cpu().numpy() for k, v in stats.items()})

    def search(self, queries, params: SearchParams, *, rotated: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
        """Multi-stage search; returns numpy (ids (B, k), dists (B, k),
        stats) like the reference."""
        return self._run_bucketed(queries, params, False, rotated)

    def search_baseline(self, queries, params: SearchParams, *,
                        rotated: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
        return self._run_bucketed(queries, params, True, rotated)

    # ------------------------------------------------------------------
    def memory_report(self) -> Dict:
        """Dtype-aware bytes by residence class (paper Table 3
        accounting).  ``pilot_bytes`` is the stage-① payload: compact
        subgraph ids + (possibly quantized) primary vectors + FES entry
        buckets, the int8/int4 scale rows and pq codebooks included."""
        A = self.arrays
        nbytes = lambda k: (int(A[k].numel() * A[k].element_size())
                            if k in A else 0)
        pilot_graph = nbytes("sub_neighbors")
        pilot_vec = (nbytes("primary") + nbytes("primary_scale") +
                     nbytes("primary_codebook"))
        pilot_fes = (nbytes("fes_entries") + nbytes("fes_entries_scale") +
                     nbytes("fes_entries_codebook"))
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


# ---------------------------------------------------------------------------
# Residency planning: solve the pilot knobs for a byte budget
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ResidencyPlan:
    """One solved operating point; ``to_config()`` turns it into an
    ``IndexConfig`` (geometry fields carried over from the planner)."""
    sample_ratio: float
    svd_ratio: float
    pilot_dtype: str
    est_pilot_bytes: int
    budget_bytes: int
    R: int
    n_entry: int
    fes_clusters: int
    pilot_id_dtype: str = "auto"

    @property
    def fits(self) -> bool:
        return self.est_pilot_bytes <= self.budget_bytes

    def to_config(self, base: Optional[IndexConfig] = None,
                  **overrides) -> IndexConfig:
        """``base`` supplies the fields the plan does not model (seed,
        build_method, coarse_ratio, ...); every byte-relevant field comes
        from the plan, so the build-time budget check matches the
        estimate.  ``overrides`` win last."""
        return dataclasses.replace(
            base or IndexConfig(), R=self.R, n_entry=self.n_entry,
            fes_clusters=self.fes_clusters,
            sample_ratio=self.sample_ratio, svd_ratio=self.svd_ratio,
            pilot_dtype=self.pilot_dtype,
            pilot_id_dtype=self.pilot_id_dtype,
            pilot_budget_bytes=self.budget_bytes, **overrides)


class ResidencyPlanner:
    """Solve ``(sample_ratio, svd_ratio, pilot_dtype)`` for a stage-①
    byte budget.  Among the feasible grid points it picks the
    lexicographic max of ``(sample_ratio, svd_ratio, dtype fidelity)`` —
    encoding fidelity goes first (fp32 → bf16 → int8 → int4 → pq), then
    SVD-primary dims, then coverage.  If nothing fits, the smallest plan
    comes back with ``fits == False``.

    ``estimate()`` mirrors ``PilotANNIndex.memory_report()``: graph and
    vector bytes exactly, and the FES term as an upper bound (the build
    caps the bucket capacity with the same ``fes.fes_capacity_cap``)."""

    SAMPLE_GRID = (0.5, 0.4, 0.33, 0.25, 0.2, 0.15, 0.1)
    SVD_GRID = (0.75, 0.5, 0.33, 0.25)

    def __init__(self, n: int, d: int, *, R: int = 32, n_entry: int = 8192,
                 fes_clusters: int = 32, pilot_id_dtype: str = "auto"):
        self.n, self.d = n, d
        self.R, self.n_entry, self.fes_clusters = R, n_entry, fes_clusters
        self.pilot_id_dtype = pilot_id_dtype

    def estimate(self, sample_ratio: float, svd_ratio: float,
                 pilot_dtype: str) -> Dict[str, int]:
        """Estimated pilot bytes, broken down like ``memory_report()``."""
        nk = max(1, int(round(sample_ratio * self.n)))
        dp = max(1, min(self.d, int(round(svd_ratio * self.d))))
        id_dt = PilotANNIndex._resolve_id_dtype(self.pilot_id_dtype, nk)
        vb = quant.encoded_row_bytes(dp, pilot_dtype)
        side = quant.side_bytes(dp, pilot_dtype)
        graph = (nk + 1) * self.R * np.dtype(id_dt).itemsize
        vec = (nk + 1) * vb + side
        cap = fes.fes_capacity_cap(min(self.n_entry, nk), self.fes_clusters)
        fes_b = self.fes_clusters * cap * vb + side
        return {"graph": graph, "vec": vec, "fes": fes_b,
                "total": graph + vec + fes_b}

    def plan(self, pilot_budget_bytes: int, *,
             sample_grid: Tuple[float, ...] = None,
             svd_grid: Tuple[float, ...] = None,
             dtypes: Tuple[str, ...] = quant.PILOT_DTYPES) -> ResidencyPlan:
        best_key, best = None, None
        fallback, fallback_est = None, None
        for sr in sample_grid or self.SAMPLE_GRID:
            for vr in svd_grid or self.SVD_GRID:
                for dt in dtypes:
                    est = self.estimate(sr, vr, dt)["total"]
                    plan = ResidencyPlan(
                        sample_ratio=sr, svd_ratio=vr, pilot_dtype=dt,
                        est_pilot_bytes=est, budget_bytes=pilot_budget_bytes,
                        R=self.R, n_entry=self.n_entry,
                        fes_clusters=self.fes_clusters,
                        pilot_id_dtype=self.pilot_id_dtype)
                    if est <= pilot_budget_bytes:
                        key = (sr, vr, quant.FIDELITY[dt])
                        if best_key is None or key > best_key:
                            best_key, best = key, plan
                    elif fallback_est is None or est < fallback_est:
                        fallback, fallback_est = plan, est
        return best if best is not None else fallback


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
