"""Segmented mutable index: streaming inserts, deletes and compaction under
live serving (DESIGN.md §6, §9) — port of ``repro.core.segments``.

* **base segment** — a ``PilotANNIndex``, never edited in place.  Deletes
  are the deletion bitmaps ``tombstone`` (n+1,) and ``pilot_tombstone``
  (nk+1,) in ``base.arrays``, made once and then updated in place
  (``copy_`` into the same storage), so the compiled searches of the base
  — CUDA graphs on the card, which hold their tensors' addresses — see
  every delete without a new capture.  All-false bitmaps give the
  bitmap-free results bit for bit.
* **delta segments** — append-only ``DeltaSegment``s with their own
  adjacency, raw/rotated/pilot rows (the pilot rows in the index's
  ``pilot_dtype``, ``core/quant.py``), optional FES buckets, a private id
  space 0..cap (sentinel ``cap``) and their own tombstones.  ``insert``
  wires new rows in with incremental repair: candidates from the delta,
  the batch peers and the base (occluders only: edges never cross
  segments), the occlusion prune and reverse-edge patching — batched on the
  index's device (``repair_method`` device/auto: ``device_build``) or per
  row on the host (host: ``graph_build``).
* **search fan-out** — the base runs the multistage search, each delta an
  exact scan (up to ``brute_threshold`` live rows) or its own pilot-graph
  traversal with an exact re-score, and the beams merge exactly in the
  global id space (``merge_topk``: canonical (distance, gid) order).
  Global ids are never reused and survive ``compact()``.
* **compact()** — folds the live rows of every segment into a fresh base
  (re-planning the pilot encoding for a ``pilot_budget_bytes``).

Every tensor lives on the index's device (``device=``, default ``cuda``;
no silent CPU fallback).  The large-delta traversal is a search program
compiled per (bucket, params, k) on its segment like the base's
(``core/compiled.py``: CUDA graphs on the card); ``DeltaSegment.refresh``
writes its tensors in place while their shapes hold, so only a capacity
doubling or an FES shape change captures again — the counterpart of the
reference's "jit signatures churn only O(log inserts) times".  A delta
segment may live on another device than the base (``_new_delta``; the pod
layer ``core/distributed.py`` places each on its owning shard's device):
its queries go to it and its top-k comes back to the host merge.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compiled, fes, graph_build, quant
from repro_torch.core import traversal as T
from repro_torch.core.devices import resolve_device
from repro_torch.core.engine import (IndexConfig, PilotANNIndex,
                                     ResidencyPlanner, arrays_from_numpy)
from repro_torch.core.multistage import (BATCH_BUCKETS, SearchParams,
                                         StatsDict, pad_to_bucket)

INF = float("inf")


@dataclass(frozen=True)
class UpdateParams:
    """Streaming-update knobs (the reference's; docs/api.md)."""
    # initial delta-segment row capacity; doubles on overflow, so device
    # shapes (and the compiled delta searches) churn only O(log inserts)
    delta_capacity: int = 256
    # insert-time candidate collection: beam width of the greedy searches
    repair_ef: int = 64
    # candidates kept per source (delta / batch peers / base)
    repair_knn: int = 16
    # occlusion-prune alpha for insert repair
    repair_alpha: float = 1.2
    # deltas with at most this many live rows are scored exactly; above it
    # the delta's own pilot graph + FES drive a traversal + exact re-score
    brute_threshold: int = 2048
    # base-segment candidates join the prune as occluder-only entries
    use_base_occluders: bool = True
    # fold deltas into a fresh base once their live rows exceed this
    # fraction of the base (None = manual compact() only)
    auto_compact_fraction: Optional[float] = None
    # insert-time repair path: "device" (batched, core/device_build on the
    # index's device), "host" (per-node numpy loops), "auto" = device
    repair_method: str = "auto"


# ---------------------------------------------------------------------------
# Canonical beam merge
# ---------------------------------------------------------------------------

def merge_topk(gids: np.ndarray, dists: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k over concatenated beams in the global id space, in the
    canonical (distance, gid) order: ties in distance break by the smaller
    gid, never by position, so the merge does not depend on how the beams
    were produced.  ``gids`` (B, M) int64 with -1 for dead/padded slots,
    ``dists`` (B, M) float32.  Returns (gids (B, k), dists (B, k)); short
    rows pad with gid -1 / +inf."""
    G = np.asarray(gids, np.int64)
    D = np.asarray(dists, np.float32)
    dead = G < 0
    D = np.where(dead, np.inf, D)
    G = np.where(dead, -1, G)
    if G.shape[1] < k:
        pad = k - G.shape[1]
        G = np.pad(G, ((0, 0), (0, pad)), constant_values=-1)
        D = np.pad(D, ((0, 0), (0, pad)), constant_values=np.inf)
    order = np.lexsort((G, D), axis=-1)[:, :k]
    return (np.take_along_axis(G, order, axis=1),
            np.take_along_axis(D, order, axis=1))


# ---------------------------------------------------------------------------
# Delta-segment scorers (torch ops on the index's device; the reference
# jit's them, with no Pallas kernel)
# ---------------------------------------------------------------------------

def _delta_brute_topk(q: torch.Tensor, rot: torch.Tensor, valid: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of one delta segment: every live row scored (ties toward
    the lower row, as ``lax.top_k``)."""
    d2 = T.sq_dists(q.float(), rot).masked_fill(~valid[None, :], INF)
    dd, idx = fes.topk_smallest(d2, k)
    return idx.to(torch.int32), dd


def _peer_topk(rot: torch.Tensor, valid: torch.Tensor, kk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-batch peer candidates for the device repair: exact top-kk
    over the (padded) insert batch, self and pad rows masked."""
    B = rot.shape[0]
    d2 = T.sq_dists(rot, rot)
    ok = valid[None, :] & ~torch.eye(B, dtype=torch.bool, device=rot.device)
    dd, idx = fes.topk_smallest(d2.masked_fill(~ok, INF), kk)
    return idx.to(torch.int32), dd


def _delta_graph_program(arrays: Dict[str, torch.Tensor],
                         params: SearchParams, k: int,
                         q: torch.Tensor) -> T.Program:
    """Large-delta search as a program: FES (or the live medoid) entries →
    traversal of the delta's own pilot table → exact re-score of the beam
    from the full rotated rows.  Returns ``(ids, dists, scored)``: local
    ids (B, k'), exact distances, and the per-query scored count."""
    cap = arrays["rot_vecs"].shape[0] - 1
    scale, codebook = arrays.get("primary_scale"), arrays.get("primary_codebook")
    dp = quant.primary_dim(arrays["primary"], scale, codebook=codebook)
    Bq = q.shape[0]
    qp = q[:, :dp].contiguous()
    if "fes_centroids" in arrays:
        L = min(params.fes_L, arrays["fes_entry_ids"].shape[1])
        entries, _ = fes.fes_select_ref(
            qp, arrays["fes_centroids"], arrays["fes_entries"],
            arrays["fes_entry_ids"], arrays["fes_valid"], L,
            entries_scale=arrays.get("fes_entries_scale"),
            entries_codebook=arrays.get("fes_entries_codebook"))
    else:
        entries = arrays["entry"][None, :].expand(Bq, 1)
    spec = T.TraversalSpec(ef=max(params.ef, k),
                           visited_mode=params.visited_mode,
                           bloom_bits=params.bloom_bits,
                           max_iters=params.max_iters,
                           frontier_width=params.frontier_width)
    st = yield from T.greedy_program(spec, qp, arrays["neighbors"],
                                     arrays["primary"], cap, entries,
                                     vec_scale=scale, vec_codebook=codebook)
    cid = st.cand_id.long()
    ok = (cid < cap) & arrays["valid"][cid.clamp(0, cap - 1)]
    d = torch.where(ok, T.sq_dists(q, arrays["rot_vecs"][cid]), INF)
    dd, idx = fes.topk_smallest(d, min(k, d.shape[1]))
    return (st.cand_id.gather(1, idx), dd,
            st.n_dist + ok.sum(1, dtype=torch.int32))


def _delta_graph_topk(arrays: Dict[str, torch.Tensor], q: torch.Tensor,
                      params: SearchParams, k: int):
    """``_delta_graph_program`` run eagerly."""
    return T.run_program(_delta_graph_program(arrays, params, k, q))


class DeltaSegment:
    """One append-only mutable segment: host build state (raw/rotated rows,
    adjacency, tombstones, global ids) plus the tensors ``refresh`` makes
    on ``device`` in its own id space 0..cap (sentinel ``cap``)."""

    def __init__(self, d: int, dp: int, R: int, cap: int, device=None):
        self.d, self.dp, self.R = d, dp, R
        self.cap = cap
        self.device = resolve_device(device)
        self.m = 0                       # rows appended so far
        self.raw = np.zeros((cap, d), np.float32)
        self.rot = np.zeros((cap, d), np.float32)
        self.gids = np.full(cap, -1, np.int64)
        self.tomb = np.zeros(cap, bool)
        self.neighbors = np.full((cap, R), cap, np.int32)
        self.entry = 0                   # live medoid (traversal entry)
        self.arrays: Dict[str, torch.Tensor] = {}
        # compiled large-delta searches over ``arrays``, keyed (bucket,
        # params, k); dropped when ``refresh`` replaces the tensors
        self.compiled: Dict[tuple, object] = {}

    def live_mask(self) -> np.ndarray:
        mask = np.zeros(self.cap, bool)
        mask[:self.m] = ~self.tomb[:self.m]
        return mask

    def live_count(self) -> int:
        return int(self.live_mask().sum())

    def grow(self, need: int) -> None:
        """Double the capacity until ``m + need`` rows fit (device shapes
        change only O(log inserts) times)."""
        new_cap = self.cap
        while new_cap < self.m + need:
            new_cap *= 2
        if new_cap == self.cap:
            return
        pad = new_cap - self.cap
        self.raw = np.concatenate([self.raw, np.zeros((pad, self.d), np.float32)])
        self.rot = np.concatenate([self.rot, np.zeros((pad, self.d), np.float32)])
        self.gids = np.concatenate([self.gids, np.full(pad, -1, np.int64)])
        self.tomb = np.concatenate([self.tomb, np.zeros(pad, bool)])
        nb = np.full((new_cap, self.R), new_cap, np.int32)
        old = self.neighbors
        nb[:self.cap] = np.where(old == self.cap, new_cap, old)  # remap sentinel
        self.neighbors = nb
        self.cap = new_cap

    def refresh(self, pilot_dtype: str, *, fes_threshold: int = 2048) -> None:
        """Rebuild the segment's tensors after a mutation batch:
        sentinel-mask tombstoned edge targets, (re)quantize the pilot rows,
        recompute the live-medoid entry and (past ``fes_threshold`` live
        rows) the delta's own FES buckets.  Where the keys, shapes and
        dtypes are those of the current tensors, the new values are copied
        into them in place (the compiled searches keep reading them);
        otherwise the tensors are replaced and the compiled searches
        dropped."""
        cap, R, dp = self.cap, self.R, self.dp
        live = self.live_mask()
        nbrs = self.neighbors.copy()
        dead_target = (nbrs < cap) & self.tomb[np.clip(nbrs, 0, cap - 1)]
        nbrs[dead_target] = cap
        table = np.concatenate([nbrs, np.full((1, R), cap, np.int32)], axis=0)
        rotz = np.concatenate([self.rot, np.zeros((1, self.d), np.float32)], 0)
        pdata, pside = quant.quantize(rotz[:, :dp], pilot_dtype)
        host = {"neighbors": table, "rot_vecs": rotz, "primary": pdata,
                "valid": live}
        side_key = ("primary_codebook" if pilot_dtype == "pq"
                    else "primary_scale")
        if pside is not None:
            host[side_key] = pside
        live_idx = np.flatnonzero(live)
        if len(live_idx):
            mu = self.rot[live_idx].mean(axis=0, keepdims=True)
            self.entry = int(live_idx[np.argmin(
                ((self.rot[live_idx] - mu) ** 2).sum(axis=1))])
        host["entry"] = np.array([self.entry], np.int32)
        if len(live_idx) > fes_threshold:
            r = int(min(8, max(2, len(live_idx) // 128)))
            fidx = fes.build_fes(self.rot[:, :dp], live_idx, r=r,
                                 n_entry=min(len(live_idx), 512))
            edata, eside = quant.quantize(fidx.entries, pilot_dtype)
            host["fes_centroids"] = fidx.centroids
            host["fes_entries"] = edata
            host["fes_entry_ids"] = fidx.entry_ids
            host["fes_valid"] = fidx.valid
            if eside is not None:
                host["fes_entries_codebook" if pilot_dtype == "pq"
                     else "fes_entries_scale"] = eside
        new = arrays_from_numpy(host, "cpu")
        old = self.arrays
        if (old.keys() == new.keys()
                and all(old[k].shape == v.shape and old[k].dtype == v.dtype
                        for k, v in new.items())):
            for k, v in new.items():
                old[k].copy_(v)
            return
        self.arrays = {k: v.to(self.device) for k, v in new.items()}
        self.compiled = {}

    def pilot_bytes(self) -> int:
        """Device-resident stage-① bytes of this segment (adjacency +
        quantized pilot rows + FES buckets)."""
        keys = ("neighbors", "primary", "primary_scale", "primary_codebook",
                "fes_entries", "fes_entries_scale", "fes_entries_codebook",
                "fes_centroids")
        return sum(int(a.numel() * a.element_size())
                   for k, a in self.arrays.items() if k in keys)

    def graph_fn(self, params: SearchParams, k: int, bucket: int):
        """The large-delta search compiled for this segment's tensors at
        ``bucket`` rows (captured at first use on the card)."""
        key = (bucket, dataclasses.astuple(params), k)
        fn = self.compiled.get(key)
        if fn is None:
            q = torch.zeros((bucket, self.d), dtype=torch.float32,
                            device=self.device)
            fn = self.compiled[key] = compiled.compile_program(
                lambda x: _delta_graph_program(self.arrays, params, k, x),
                (q,))
        return fn


class SegmentedIndex:
    """Mutable PilotANN index: immutable base + append-only delta segments
    + tombstones, searched by fan-out with an exact beam merge (module
    docstring).  Results are *global ids*: assigned monotonically at insert
    time, stable across ``compact()``."""

    def __init__(self, cfg: IndexConfig, vectors: np.ndarray,
                 update_params: Optional[UpdateParams] = None, *,
                 device=None):
        self.up = update_params or UpdateParams()
        self.device = resolve_device(device)
        self._vectors = np.ascontiguousarray(vectors, np.float32)
        self.base = PilotANNIndex(cfg, self._vectors, device=self.device)
        n = self.base.n
        self._base_gids = np.arange(n, dtype=np.int64)
        self._base_tomb = np.zeros(n, bool)
        self._gid_dead = np.zeros(n, bool)     # global tombstone lookup
        self._next_gid = n
        self.deltas: List[DeltaSegment] = []
        self.generation = 0                    # bumped by compact()
        self._warm_ctx: Optional[Tuple[SearchParams, Tuple[int, ...]]] = None
        self._install_base_tombstones()

    # -- delegation --------------------------------------------------------
    @property
    def d(self) -> int:
        return self.base.d

    @property
    def n_total(self) -> int:
        return self.base.n + sum(s.m for s in self.deltas)

    @property
    def n_live(self) -> int:
        return int((~self._base_tomb).sum()) + \
            sum(s.live_count() for s in self.deltas)

    def rotate_queries(self, queries) -> torch.Tensor:
        return self.base.rotate_queries(queries)

    def warmup(self, params: SearchParams,
               buckets: Optional[Tuple[int, ...]] = None) -> None:
        """Run the mutation/merge path once outside any serving window: the
        repair candidate search of the base (compiled, on the card
        captured, per bucket), the delta scorers at the current capacity
        rung and the batched prune; and remember ``params`` so that a
        delta crossing ``brute_threshold`` has its compiled search made
        during the mutation drain, not in the next served batch."""
        buckets = buckets or BATCH_BUCKETS
        kk = max(1, self.up.repair_knn)
        if self.up.use_base_occluders:
            for b in buckets:
                self._base_candidates(np.zeros((b, self.d), np.float32), kk)
        cap = self.deltas[-1].cap if self.deltas else \
            max(self.up.delta_capacity, 8)
        rot = torch.zeros((cap, self.d), dtype=torch.float32,
                          device=self.device)
        valid = torch.zeros((cap,), dtype=torch.bool, device=self.device)
        k_eff = max(1, min(params.k, cap))
        for b in buckets:
            q = torch.zeros((b, self.d), dtype=torch.float32,
                            device=self.device)
            _delta_brute_topk(q, rot, valid, k_eff)
        if self.up.repair_method != "host":
            from repro_torch.core import device_build
            rk = max(1, min(kk, cap))
            for b in buckets:
                q = torch.zeros((b, self.d), dtype=torch.float32,
                                device=self.device)
                _delta_brute_topk(q, rot, valid, rk)
                _peer_topk(q, torch.zeros((b,), dtype=torch.bool,
                                          device=self.device),
                           max(1, min(kk, b - 1)))
            device_build.warm_prune_batch(
                [(b, 3 * kk, self.d) for b in buckets], self.base.cfg.R,
                device=self.device)
        self._warm_ctx = (params, tuple(buckets))
        for seg in self.deltas:
            self._maybe_warm_graph_path(seg)

    def _maybe_warm_graph_path(self, seg: DeltaSegment) -> None:
        """Compile the above-``brute_threshold`` delta search of ``seg`` at
        the serving buckets, off the serve path (after a mutation refresh;
        nothing until ``warmup`` recorded a serving context, or while the
        delta is brute-scored).  A segment's compiled searches survive an
        in-place refresh, so this captures only after a shape change."""
        if (self._warm_ctx is None
                or seg.live_count() <= self.up.brute_threshold):
            return
        params, buckets = self._warm_ctx
        k_eff = max(1, min(params.k, seg.cap))
        for b in buckets:
            seg.graph_fn(params, k_eff, b)

    # -- tombstones --------------------------------------------------------
    def _install_base_tombstones(self) -> None:
        """Write the base's deletion bitmaps.  The tensors are made once
        per base and then updated in place, so every compiled search and
        stage pair that reads them sees a delete at its next call, with no
        new capture (the reference passes them as jit arguments instead).
        All-false bitmaps are bit-exact with the bitmap-free build."""
        n, nk = self.base.n, self.base.n_pilot
        tomb = np.zeros(n + 1, bool)
        tomb[:n] = self._base_tomb
        ptomb = np.zeros(nk + 1, bool)
        ptomb[:nk] = self._base_tomb[self.base.keep_ids]
        A = self.base.arrays
        for key, bits in (("tombstone", tomb), ("pilot_tombstone", ptomb)):
            t = torch.from_numpy(bits)
            if key in A and A[key].shape == t.shape:
                A[key].copy_(t)
            else:
                A[key] = t.to(self.device)

    def is_live(self, gids: np.ndarray) -> np.ndarray:
        """Liveness of global ids (False for unknown/negative ids)."""
        g = np.asarray(gids, np.int64)
        ok = (g >= 0) & (g < self._next_gid)
        return ok & ~self._gid_dead[np.clip(g, 0, self._next_gid - 1)]

    def delete(self, gids) -> int:
        """Tombstone global ids; returns how many were live before.  Every
        search path honours the bitmaps from the next query on; storage is
        reclaimed by ``compact()``."""
        changed_base = False
        changed = set()
        count = 0
        for g in np.atleast_1d(np.asarray(gids, np.int64)):
            if g < 0 or g >= self._next_gid or self._gid_dead[g]:
                continue
            self._gid_dead[g] = True
            count += 1
            i = np.searchsorted(self._base_gids, g)
            if i < len(self._base_gids) and self._base_gids[i] == g:
                self._base_tomb[i] = True
                changed_base = True
                continue
            for si, seg in enumerate(self.deltas):
                j = np.searchsorted(seg.gids[:seg.m], g)
                if j < seg.m and seg.gids[j] == g:
                    seg.tomb[j] = True
                    changed.add(si)
                    break
        if changed_base:
            self._install_base_tombstones()
        for si in changed:
            self.deltas[si].refresh(self.base.cfg.pilot_dtype,
                                    fes_threshold=self.up.brute_threshold)
            self._maybe_warm_graph_path(self.deltas[si])
        return count

    # -- insert ------------------------------------------------------------
    def _new_delta(self, device) -> DeltaSegment:
        """An empty delta segment whose tensors live on ``device``."""
        return DeltaSegment(self.d, self.base.reducer.d_primary,
                            self.base.cfg.R, max(self.up.delta_capacity, 8),
                            device=device)

    def _ensure_delta(self, need: int) -> DeltaSegment:
        if not self.deltas:
            self.deltas.append(self._new_delta(self.device))
        seg = self.deltas[-1]
        seg.grow(need)
        return seg

    def _base_candidates(self, rot_q: np.ndarray, kk: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Greedy-search-guided base candidates (ids, dists, vectors) for
        insert-time repair: the base's compiled search of the padded bucket
        on already-rotated queries (only ids and distances are read)."""
        sp = SearchParams(k=kk, ef=max(self.up.repair_ef, kk),
                          ef_pilot=max(self.up.repair_ef, kk))
        q = torch.from_numpy(np.ascontiguousarray(rot_q, np.float32)
                             ).to(self.device)
        q, B = pad_to_bucket(q, self.base.batch_buckets)
        ids, dists, _ = self.base._get_fn(sp, False, q.shape[0])(q)
        vecs = self.base.arrays["rot_vecs"][ids.long().clamp(0, self.base.n)]
        return (ids[:B].cpu().numpy(), dists[:B].cpu().numpy(),
                vecs[:B].cpu().numpy())

    def _collect_candidates_device(self, seg: DeltaSegment, rot: np.ndarray,
                                   m0: int, b: int
                                   ) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray]:
        """Device-path candidate collection for insert repair: nearest live
        delta rows, batch peers and base occluders, scored on the index's
        device and assembled into fixed-width (b, 3·kk) arrays (absent
        sources stay +inf).  Runs on the pre-insert delta tensors, which
        hold the host path's pre-write live set exactly."""
        up = self.up
        kk = max(1, up.repair_knn)
        cid = np.full((b, 3 * kk), -1, np.int64)
        cd = np.full((b, 3 * kk), np.inf, np.float32)
        cv = np.zeros((b, 3 * kk, self.d), np.float32)
        cok = np.zeros((b, 3 * kk), bool)
        q, _ = pad_to_bucket(torch.from_numpy(rot).to(seg.device),
                             self.base.batch_buckets)
        live = seg.live_count()
        if live:
            k_eff = max(1, min(kk, seg.cap))
            if live <= up.brute_threshold:
                ids, dd = _delta_brute_topk(q, seg.arrays["rot_vecs"][:-1],
                                            seg.arrays["valid"], k_eff)
            else:
                sp = SearchParams(k=k_eff, ef=max(up.repair_ef, k_eff),
                                  ef_pilot=max(up.repair_ef, k_eff))
                ids, dd, _ = seg.graph_fn(sp, k_eff, q.shape[0])(q)
            ids = ids[:b].cpu().numpy().astype(np.int64)
            dd = dd[:b].cpu().numpy().astype(np.float32)
            fin = np.isfinite(dd)
            cid[:, :k_eff] = np.where(fin, ids, -1)
            cd[:, :k_eff] = dd
            cv[:, :k_eff] = seg.rot[np.clip(ids, 0, seg.cap - 1)]
            cok[:, :k_eff] = fin
        if b > 1:
            valid = torch.arange(q.shape[0], device=q.device) < b
            k_eff = max(1, min(kk, int(q.shape[0]) - 1))
            idx, dd = _peer_topk(q, valid, k_eff)
            idx = idx[:b].cpu().numpy()
            dd = dd[:b].cpu().numpy().astype(np.float32)
            fin = np.isfinite(dd)
            blk = slice(kk, kk + k_eff)
            cid[:, blk] = np.where(fin, m0 + idx.astype(np.int64), -1)
            cd[:, blk] = dd
            cv[:, blk] = rot[np.clip(idx, 0, b - 1)]
            cok[:, blk] = fin
        if up.use_base_occluders and (~self._base_tomb).any():
            bids, bd, bvecs = self._base_candidates(rot, kk)
            bd = np.where(bids < self.base.n, bd, np.inf).astype(np.float32)
            take = min(kk, bids.shape[1])
            blk = slice(2 * kk, 2 * kk + take)
            cd[:, blk] = bd[:, :take]
            cv[:, blk] = bvecs[:, :take]
            # base candidates join as occluders only: cid stays -1 and
            # cok stays False (edges never cross segments)
        return cid, cd, cv, cok

    def insert(self, vectors: np.ndarray) -> np.ndarray:
        """Append vectors as new live rows; returns their global ids.

        Incremental graph repair: candidates from the base index, the delta
        and the batch peers, occlusion-pruned with the offline build's
        predicate, then reverse edges patched within the delta with a
        re-prune of overflowing rows.  ``repair_method`` "device"/"auto"
        batches collection, prune and patch on the index's device
        (``core/device_build``); "host" runs the per-row numpy loops.
        Single-row inserts give the same adjacency either way."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        b = len(vectors)
        if b == 0:
            return np.zeros(0, np.int64)
        up = self.up
        if up.repair_method not in ("auto", "device", "host"):
            raise ValueError(f"unknown repair_method {up.repair_method!r} "
                             "(auto | device | host)")
        use_device = up.repair_method != "host"
        rot = np.ascontiguousarray(self.base.reducer.rotate(vectors),
                                   np.float32)
        seg = self._ensure_delta(b)
        m0, cap, R = seg.m, seg.cap, seg.R

        # ---- candidate collection (pre-write live set) ----------------
        if use_device:
            dcid, dcd, dcv, dcok = self._collect_candidates_device(
                seg, rot, m0, b)
        cand_parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray, bool]] = []
        kk = max(1, up.repair_knn)
        if not use_device:
            live_idx = np.flatnonzero(seg.live_mask())
            if len(live_idx):
                if len(live_idx) <= up.brute_threshold:
                    d2 = graph_build.pairwise_sq_dists(rot, seg.rot[live_idx])
                    take = min(kk, len(live_idx))
                    part = np.argpartition(d2, take - 1, axis=1)[:, :take]
                    ids = live_idx[part].astype(np.int64)
                    dd = np.take_along_axis(d2, part, axis=1)
                else:
                    ids, dd = graph_build.greedy_candidates(
                        seg.neighbors, seg.rot, rot, seg.entry,
                        ef=up.repair_ef, live=seg.live_mask())
                    ids, dd = ids[:, :kk], dd[:, :kk]
                cand_parts.append((ids, dd.astype(np.float32),
                                   seg.rot[np.clip(ids, 0, cap - 1)], True))
            if b > 1:
                d2p = graph_build.pairwise_sq_dists(rot, rot)
                np.fill_diagonal(d2p, np.inf)
                take = min(kk, b - 1)
                part = np.argpartition(d2p, take - 1, axis=1)[:, :take]
                pe_ids = (m0 + part).astype(np.int64)
                pe_d = np.take_along_axis(d2p, part, axis=1).astype(np.float32)
                cand_parts.append((pe_ids, pe_d, rot[part], True))
            if up.use_base_occluders and (~self._base_tomb).any():
                bids, bd, bvecs = self._base_candidates(rot, kk)
                bd = np.where(bids < self.base.n, bd,
                              np.inf).astype(np.float32)
                cand_parts.append((np.full_like(bids, -1, dtype=np.int64),
                                   bd, bvecs, False))

        # ---- occlusion prune + write rows -----------------------------
        seg.raw[m0:m0 + b] = vectors
        seg.rot[m0:m0 + b] = rot
        gids = np.arange(self._next_gid, self._next_gid + b, dtype=np.int64)
        seg.gids[m0:m0 + b] = gids
        self._next_gid += b
        self._gid_dead = np.concatenate([self._gid_dead, np.zeros(b, bool)])
        if use_device:
            # (imported here: core/device_build imports the kernels
            # package, which imports core)
            from repro_torch.core import device_build
            # rows are pruned independently, so the reference's padding of
            # the batch to a bucket (for its jit cache) is left out
            kept = device_build.prune_batch(dcv, dcd, R,
                                            alpha=up.repair_alpha,
                                            edge_ok=dcok, device=self.device)
            for i in range(b):
                sel = kept[i][kept[i] >= 0]
                edges = dcid[i, sel]
                edges = edges[edges >= 0]
                seg.neighbors[m0 + i, :len(edges)] = edges.astype(np.int32)
            seg.m = m0 + b
            device_build.patch_reverse_edges_batched(
                seg.neighbors, seg.rot, np.arange(m0, m0 + b), cap, R,
                alpha=up.repair_alpha, device=self.device)
        else:
            for i in range(b):
                if not cand_parts:
                    break
                cv = np.concatenate([p[2][i] for p in cand_parts], axis=0)
                cd = np.concatenate([p[1][i] for p in cand_parts], axis=0)
                cid = np.concatenate([p[0][i] for p in cand_parts], axis=0)
                ok = np.concatenate([np.full(len(p[0][i]), p[3])
                                     for p in cand_parts], axis=0)
                kept = graph_build.prune_one(cv, cd, R,
                                             alpha=up.repair_alpha,
                                             edge_ok=ok)
                edges = cid[kept]
                seg.neighbors[m0 + i, :len(edges)] = edges.astype(np.int32)
            seg.m = m0 + b
            graph_build.patch_reverse_edges(seg.neighbors, seg.rot,
                                            np.arange(m0, m0 + b), cap, R,
                                            alpha=up.repair_alpha)
        seg.refresh(self.base.cfg.pilot_dtype,
                    fes_threshold=up.brute_threshold)
        self._maybe_warm_graph_path(seg)
        self._maybe_auto_compact()
        return gids

    def _maybe_auto_compact(self) -> None:
        frac = self.up.auto_compact_fraction
        if frac is None:
            return
        delta_live = sum(s.live_count() for s in self.deltas)
        if delta_live > frac * max(1, self.base.n):
            self.compact()

    # -- compaction --------------------------------------------------------
    def compact(self, *, replan: bool = True) -> "SegmentedIndex":
        """Fold every segment's live rows into a fresh immutable base (SVD,
        graphs and FES rebuilt; tombstones and deltas cleared; global ids
        kept).  With ``replan`` and a ``pilot_budget_bytes``, the
        ``ResidencyPlanner`` re-solves the pilot knobs for the merged
        corpus first, so the budget keeps holding as the index grows."""
        live_base = ~self._base_tomb
        vec_parts = [self._vectors[live_base]]
        gid_parts = [self._base_gids[live_base]]
        for seg in self.deltas:
            live = seg.live_mask()[:seg.m]
            vec_parts.append(seg.raw[:seg.m][live])
            gid_parts.append(seg.gids[:seg.m][live])
        x = np.concatenate(vec_parts, axis=0)
        g = np.concatenate(gid_parts, axis=0)
        # canonical row order: ascending gid (the graph build is row-order
        # sensitive)
        order = np.argsort(g, kind="stable")
        x, g = x[order], g[order]
        cfg = self.base.cfg
        if replan and cfg.pilot_budget_bytes is not None:
            plan = ResidencyPlanner(
                len(x), self.d, R=cfg.R, n_entry=cfg.n_entry,
                fes_clusters=cfg.fes_clusters,
                pilot_id_dtype=cfg.pilot_id_dtype,
            ).plan(cfg.pilot_budget_bytes)
            cfg = plan.to_config(cfg)
        self.base = PilotANNIndex(cfg, x, device=self.device)
        self._vectors = x
        self._base_gids = g
        self._base_tomb = np.zeros(len(x), bool)
        self.deltas = []
        self.generation += 1
        self._install_base_tombstones()
        return self

    # -- search ------------------------------------------------------------
    def _delta_topk(self, q_rot: torch.Tensor, seg: DeltaSegment, k: int,
                    params: SearchParams
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k of one delta for a rotated query batch: exact scan up to
        ``brute_threshold`` live rows, the compiled pilot-graph traversal
        + exact re-score above it.  Returns local ids, exact distances and
        the per-query scored count."""
        q_rot, B0 = pad_to_bucket(q_rot.to(seg.device))
        k_eff = max(1, min(k, seg.cap))
        if seg.live_count() <= self.up.brute_threshold:
            ids, dd = _delta_brute_topk(q_rot, seg.arrays["rot_vecs"][:-1],
                                        seg.arrays["valid"], k_eff)
            cnt = np.full(B0, seg.live_count(), np.int32)
            return ids[:B0].cpu().numpy(), dd[:B0].cpu().numpy(), cnt
        ids, dd, cnt = seg.graph_fn(params, k_eff, q_rot.shape[0])(q_rot)
        return (ids[:B0].cpu().numpy(), dd[:B0].cpu().numpy(),
                cnt[:B0].cpu().numpy())

    def _live_deltas(self) -> List[DeltaSegment]:
        """The delta segments a search merges: all of them here; the pod
        layer leaves out those of dead shards (``core/distributed.py``)."""
        return self.deltas

    def merge_with_deltas(self, q_rot: torch.Tensor, base_ids: np.ndarray,
                          base_d: np.ndarray, k: int, params: SearchParams
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact cross-segment beam merge: base results (positional ids)
        map to global ids, each of ``_live_deltas`` adds its top-k, anything
        tombstoned *since dispatch* is dropped, and the union is sorted by
        ``merge_topk``'s canonical order.  Returns (gids (B, k), dists
        (B, k), delta-scored counts (B,)); short rows pad with gid -1 /
        +inf."""
        n = self.base.n
        base_ids = np.asarray(base_ids)
        base_d = np.asarray(base_d, np.float32)
        ok = (base_ids < n) & (base_ids >= 0) & np.isfinite(base_d)
        all_g = [np.where(ok, self._base_gids[np.clip(base_ids, 0, n - 1)],
                          -1)]
        all_d = [np.where(ok, base_d, np.inf)]
        Bq = base_ids.shape[0]
        scored = np.zeros(Bq, np.int32)
        for seg in self._live_deltas():
            if seg.live_count() == 0:
                continue
            lids, ld, cnt = self._delta_topk(q_rot, seg, k, params)
            lv = np.isfinite(ld)
            all_g.append(np.where(lv, seg.gids[np.clip(lids, 0, seg.cap - 1)],
                                  -1))
            all_d.append(np.where(lv, ld, np.inf))
            scored += cnt
        G = np.concatenate(all_g, axis=1)
        D = np.concatenate(all_d, axis=1)
        live = self.is_live(G)
        D = np.where(live, D, np.inf)
        G = np.where(live, G, -1)
        mg, md = merge_topk(G, D, k)
        return mg, md, scored

    def search(self, queries, params: SearchParams, *, rotated: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, StatsDict]:
        """Fan-out search: multistage on the tombstone-masked base, per-delta
        top-k, exact merge.  Returns numpy ``(gids, dists, stats)`` with the
        base's stats plus ``delta_dist`` (per-query delta rows scored)."""
        q = (torch.as_tensor(queries, dtype=torch.float32).to(self.device)
             if rotated else self.rotate_queries(
                 np.asarray(queries, np.float32)))
        ids_b, d_b, stats = self.base.search(q, params, rotated=True)
        gids, dists, scored = self.merge_with_deltas(q, ids_b, d_b,
                                                     params.k, params)
        stats = dict(stats)
        stats["delta_dist"] = scored
        return gids, dists, stats

    # -- accounting --------------------------------------------------------
    def memory_report(self) -> Dict:
        """The base's report plus per-segment pilot bytes: ``segments``
        (nodes/live/pilot_bytes per segment), ``delta_pilot_bytes`` and
        ``total_pilot_bytes``."""
        rep = dict(self.base.memory_report())
        segs = [{"segment": "base", "nodes": self.base.n,
                 "live": int((~self._base_tomb).sum()),
                 "pilot_bytes": rep["pilot_bytes"]}]
        delta_pilot = 0
        for i, seg in enumerate(self.deltas):
            pb = seg.pilot_bytes()
            delta_pilot += pb
            segs.append({"segment": f"delta{i}", "nodes": seg.m,
                         "live": seg.live_count(), "pilot_bytes": pb})
        rep["segments"] = segs
        rep["delta_pilot_bytes"] = delta_pilot
        rep["total_pilot_bytes"] = rep["pilot_bytes"] + delta_pilot
        return rep
