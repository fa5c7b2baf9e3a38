"""Pod-scale PilotANN: the sharded search step and the sharded serving
index — port of ``repro.core.distributed``.

Mapping (DESIGN.md §2): every shard holds a replica of the *pilot index*
(subgraph CSR + SVD-primary vectors + FES clusters); the *full index*
(graph + full-d vectors) is sharded row-wise.  Stage ① is replicated;
stages ②③ traverse the sharded full index, where each neighbour gather
crosses the corpus sharding.

**One controller.**  The reference runs its shards as SPMD programs
(``shard_map``) under one controller.  The port's counterpart is one
process that holds a list of ``torch.device``s (a ``PodMesh``) and computes
each shard's part on its own device, as FAISS's multi-GPU ``IndexShards``
does.  K shards may share one device (``devices=["cuda:0"] * K`` on one
card, ``["cpu"] * K`` in the tests): every shard still answers only for the
rows it owns, from its own slice.

**Owner computes, and the owner's value is selected.**  Every global row
``g`` is owned by shard ``g // rows_per``.  Each shard scores the whole
``(B, E)`` id block with clipped local indices (static shapes, so the CUDA
graphs of ``core/compiled.py`` record the hooks), and ``owner_select`` takes
each element from its owner's contribution.  The reference adds exact zeros
from the other shards (a psum); a select keeps the owner's bits by
construction, where an addition would turn a ``-0.0`` into ``+0.0``.  The
cross-shard beam merge is ``segments.merge_topk``'s canonical (distance,
gid) order, which does not depend on the row-to-shard assignment.  So the
sharded index gives the single-device index's ids and distance bits at every
shard count.  ``owner_select`` is the one cross-shard reduction: a
deployment of one process per device would put a collective behind it.

Two gather schemes for the dry-run step (``make_pod_search_step``):
  * ``naive``     — each shard gathers the ``(B, E, d)`` rows it owns, the
                    owners' rows are selected and scored (vectors move).
  * ``shardwise`` — each shard scores its rows, and only the ``(B, E)``
                    distances and ``(B, R)`` neighbour rows move.

Pod-scale *serving*: ``ShardedSegmentedIndex`` partitions the mutable
``core/segments.SegmentedIndex`` — hot pilot payloads replicated, cold
tables (``COLD_KEYS``) row-sharded, delta segments owned round-robin — and
serves it through ``pipeline.split_stages(shard_ctx=...)``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core import multistage as M
from repro_torch.core import quant
from repro_torch.core import traversal as T
from repro_torch.core.devices import resolve_device
from repro_torch.core.multistage import SearchParams, pad_to_bucket
from repro_torch.core.segments import DeltaSegment, SegmentedIndex

INF = float("inf")


# ---------------------------------------------------------------------------
# Sizing and layout (dry-run)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PodIndexSpec:
    """Production-scale index geometry (dry-run sizing), the reference's."""
    n: int = 100_000_000          # corpus size (DEEP/T2I/WIKI/LAION: 1e8)
    d: int = 96                   # vector dim (DEEP 96 ... LAION 768)
    d_primary: int = 48
    R: int = 32                   # graph degree
    n_pilot: int = 2_000_000      # replicated pilot subgraph nodes
    fes_r: int = 32
    fes_capacity: int = 2048
    query_batch: int = 4096       # global in-flight query batch
    ef_pilot: int = 64
    ef: int = 64
    pilot_iters: int = 48         # fixed rounds (serving SLA style)
    refine_iters: int = 2
    final_iters: int = 24
    bloom_bits: int = 16384
    frontier_width: int = 1       # stage-②③ candidates expanded per round
    frontier_width_pilot: int = 1  # stage-① multi-frontier width
    vec_dtype: str = "float32"    # corpus vector storage
    pilot_dtype: str = "float32"  # float32|bfloat16|int8|int4|pq
    # mutable pod serving: tombstone bitmaps and per-shard delta-segment
    # tables in the specs and placements
    mutable: bool = False
    n_delta_segments: int = 8     # open delta segments (round-robin owned)
    delta_capacity: int = 65536   # rows per delta segment

    def pilot_bytes(self) -> int:
        """Per-shard replicated pilot payload, dtype-aware."""
        vb = quant.encoded_row_bytes(self.d_primary, self.pilot_dtype)
        side = 2 * quant.side_bytes(self.d_primary, self.pilot_dtype)
        return (self.n_pilot * vb
                + self.n_pilot * self.R * 4
                + self.fes_r * self.fes_capacity * vb
                + side)

    def full_bytes(self) -> int:
        return self.n * self.d * 4 + self.n * self.R * 4

    def delta_bytes(self) -> int:
        """Delta-segment payload across the pod (adjacency + quantized
        pilot rows + side + gids + liveness); 0 unless ``mutable``."""
        if not self.mutable:
            return 0
        vb = quant.encoded_row_bytes(self.d_primary, self.pilot_dtype)
        side = quant.side_bytes(self.d_primary, self.pilot_dtype)
        per = (self.delta_capacity * self.R * 4
               + self.delta_capacity * vb
               + side
               + self.delta_capacity * 8      # global ids (int64)
               + self.delta_capacity)         # live bitmap
        return self.n_delta_segments * per


def _pilot_storage(dp: int, pilot_dtype: str):
    """Stored-table layout of one pilot encoding (``core/quant.py``):
    ``(row_width, element_dtype, side_shape)``."""
    if pilot_dtype == "int4":
        return quant.int4_packed_width(dp), torch.int8, (dp,)
    if pilot_dtype == "pq":
        m, _, ksub = quant.pq_geometry(dp)
        return m, torch.int8, (dp, m * ksub)
    return dp, getattr(torch, pilot_dtype), (dp,)


def _round_to(x: int, k: int) -> int:
    return -(-x // k) * k


class PodMesh:
    """A named grid of ``torch.device``s, the counterpart of
    ``jax.sharding.Mesh``: ``devices`` an object array with one dimension
    per name in ``axis_names``; ``shape[axis]`` its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axes: Sequence[str]) -> List[torch.device]:
        """One device per shard of a table sharded over ``axes``, in shard
        order (row-major over ``axes`` as listed): where the other axes
        replicate a shard, their first device computes it."""
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in order]
        grid = np.transpose(self.devices, order + rest)
        grid = grid[(Ellipsis,) + (0,) * len(rest)] if rest else grid
        return list(np.asarray(grid, dtype=object).ravel())


@dataclass(frozen=True)
class Placement:
    """Where a table lives on a ``PodMesh`` (the counterpart of
    ``NamedSharding``): row-sharded over ``axes``; no axes is
    replicated."""
    axes: Tuple[str, ...] = ()


def pod_array_specs(spec: PodIndexSpec, mesh: PodMesh
                    ) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype stand-ins (``meta`` tensors) for every index array
    and the queries."""
    n_dev = int(mesh.devices.size)
    Np = _round_to(spec.n + 1, n_dev)
    npl = _round_to(spec.n_pilot + 1, 1)
    pw, pdt, sshape = _pilot_storage(spec.d_primary, spec.pilot_dtype)
    f32, i32 = torch.float32, torch.int32
    shapes = {
        # replicated pilot index (the *_scale slots carry the encoding's
        # side payload: scale rows, or the pq codebook)
        "pilot_neighbors": ((npl, spec.R), i32),
        "pilot_vecs": ((npl, pw), pdt),
        "pilot_scale": (sshape, f32),
        "pilot_to_full": ((npl,), i32),
        "fes_centroids": ((spec.fes_r, spec.d_primary), f32),
        "fes_entries": ((spec.fes_r, spec.fes_capacity, pw), pdt),
        "fes_scale": (sshape, f32),
        "fes_entry_ids": ((spec.fes_r, spec.fes_capacity), i32),
        "fes_valid": ((spec.fes_r, spec.fes_capacity), torch.bool),
        # sharded full index
        "full_neighbors": ((Np, spec.R), i32),
        "full_vecs": ((Np, spec.d), getattr(torch, spec.vec_dtype)),
        # queries (rotated, full-d)
        "queries": ((spec.query_batch, spec.d), f32),
    }
    if spec.mutable:
        S, C = spec.n_delta_segments, spec.delta_capacity
        shapes.update({
            "tombstone": ((Np,), torch.bool),
            "pilot_tombstone": ((npl,), torch.bool),
            "delta_neighbors": ((S, C, spec.R), i32),
            "delta_pilot": ((S, C, pw), pdt),
            "delta_pilot_scale": ((S,) + sshape, f32),
            "delta_gids": ((S, C), torch.int64),
            "delta_valid": ((S, C), torch.bool),
        })
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in shapes.items()}


def pod_shardings(spec: PodIndexSpec, mesh: PodMesh, *, corpus_axes=None,
                  query_axes=None) -> Dict[str, Placement]:
    """Placement per key: pilot replicated, corpus row-sharded over
    ``corpus_axes`` (default: every mesh axis), stage-②③ queries over the
    remaining axes (all of them if the corpus takes every axis)."""
    axes = mesh.axis_names
    corpus_axes = tuple(corpus_axes or axes)
    query_axes = tuple(query_axes or tuple(a for a in axes
                                           if a not in corpus_axes) or axes)
    rep, row = Placement(), Placement(corpus_axes)
    out = {k: rep for k in ("pilot_neighbors", "pilot_vecs", "pilot_scale",
                            "pilot_to_full", "fes_centroids", "fes_entries",
                            "fes_scale", "fes_entry_ids", "fes_valid")}
    out.update(full_neighbors=row, full_vecs=row,
               queries=Placement(query_axes))
    if spec.mutable:
        # tombstones ride with the replicated pilot payload; delta segments
        # are owned round-robin: sharded over segment slots, not rows
        out.update(tombstone=rep, pilot_tombstone=rep,
                   **{k: row for k in ("delta_neighbors", "delta_pilot",
                                       "delta_pilot_scale", "delta_gids",
                                       "delta_valid")})
    return out


def place_arrays(arrays: Dict[str, torch.Tensor],
                 shardings: Dict[str, Placement], mesh: PodMesh
                 ) -> Dict[str, object]:
    """Put ``arrays`` on ``mesh`` as ``shardings`` says: a row-sharded key
    becomes the tuple of its shards' row slices, each on its shard's device
    (rows must divide by the shard count, as ``pod_array_specs`` pads
    them); a replicated key — the queries too: one controller holds the
    whole batch — goes to the controller's device (the mesh's first)."""
    home = mesh.devices.flat[0]
    out = {}
    for k, v in arrays.items():
        axes = shardings[k].axes if k != "queries" else ()
        if not axes:
            out[k] = v.to(home)
            continue
        devs = mesh.axis_devices(axes)
        if v.shape[0] % len(devs):
            raise ValueError(f"{k}: {v.shape[0]} rows do not divide over "
                             f"{len(devs)} shards")
        rp = v.shape[0] // len(devs)
        out[k] = tuple(v[s * rp:(s + 1) * rp].to(d)
                       for s, d in enumerate(devs))
    return out


# ---------------------------------------------------------------------------
# The shard hooks: owner computes, the owner's value is selected
# ---------------------------------------------------------------------------

def owner_of(ids: torch.Tensor, rows_per: int, n_shards: int) -> torch.Tensor:
    """The shard that owns each global row id."""
    return (ids.long() // rows_per).clamp(max=n_shards - 1)


def owner_select(parts: Sequence[torch.Tensor],
                 owner: torch.Tensor) -> torch.Tensor:
    """The cross-shard reduction: each element from the contribution of the
    shard that owns it (``parts[s]`` is shard s's, any device; ``owner``
    broadcasts against them and sets the result's device).  A select, so
    the owner's bits come through unchanged.  Recorded in the collective
    ledger as the all-reduce the reference's psum is (``core/
    collectives.py``)."""
    out = parts[0].to(owner.device)
    for s in range(1, len(parts)):
        out = torch.where(owner == s, parts[s].to(owner.device), out)
    collectives.record("all-reduce", collectives.tensor_bytes(out))
    return out


def _local_rows(table: torch.Tensor, ids: torch.Tensor, s: int,
                rows_per: int) -> torch.Tensor:
    """Shard ``s``'s rows at global ``ids``, on its device.  Ids it does not
    own read a clipped local row, which ``owner_select`` discards."""
    loc = ids.to(table.device).long() - s * rows_per
    return table[loc.clamp(0, table.shape[0] - 1)]


def shard_local_nbr_fn(tables: Sequence[torch.Tensor], rows_per: int):
    """Neighbour-row hook over a row-sharded adjacency (``tables[s]``:
    shard s's rows ``s*rows_per ..``): ``nbr_fn(u) -> (B, R)``, each row
    from the shard that owns it.  Values in the table are global ids, so
    only rows are partitioned."""
    K = len(tables)

    def nbr_fn(u: torch.Tensor) -> torch.Tensor:
        parts = [_local_rows(t, u, s, rows_per) for s, t in enumerate(tables)]
        return owner_select(parts, owner_of(u, rows_per, K)[:, None])
    return nbr_fn


def shard_local_dist_fn(tables: Sequence[torch.Tensor], rows_per: int):
    """Distance hook over a row-sharded vector table, with
    ``refine_stage``'s exactness contract: ``dist_fn(q, ids[, fresh])``
    -> ``(B, E)``, where each shard computes ``traversal.sq_dists`` of the
    rows it owns (the same row bytes, the same formula and the same
    ``(B, E, d)`` shape as one device's gather) and the owner's value is
    selected.  So the sharded stages reproduce one device's distances bit
    for bit."""
    K = len(tables)

    def dist_fn(q: torch.Tensor, ids: torch.Tensor, fresh=None):
        parts = [T.sq_dists(q.to(t.device), _local_rows(t, ids, s, rows_per))
                 for s, t in enumerate(tables)]
        return owner_select(parts, owner_of(ids, rows_per, K).to(q.device))
    return dist_fn


def _gather_rows(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                 rows_per: int) -> torch.Tensor:
    """Gather ``(B, E)`` rows of a row-sharded ``(N, d)`` table -> ``(B, E,
    d)`` on the ids' device, each row from its owner (``naive``)."""
    parts = [_local_rows(t, ids, s, rows_per) for s, t in enumerate(tables)]
    return owner_select(parts, owner_of(ids, rows_per, len(tables))[..., None])


def make_shardwise_fns(mesh: PodMesh, corpus_axes, query_spec, N: int,
                       R: int):
    """``(nbr_fn_for, dist_fn_for)``: each takes a table's shards (a tuple
    in ``mesh.axis_devices(corpus_axes)`` order) and returns the hook
    ``traversal.expansion_round`` takes — rows and distances computed
    shard-side, only ``(B, R)`` rows and ``(B, E)`` scalars moved.
    ``query_spec`` is the reference's layout of the stage-②③ batch; one
    controller holds the whole batch, so it places nothing here."""
    n_shards = int(np.prod([mesh.shape[a] for a in corpus_axes]))
    rows_per = N // n_shards

    def nbr_fn_for(neighbor_shards):
        return shard_local_nbr_fn(neighbor_shards, rows_per)

    def dist_fn_for(vec_shards):
        return shard_local_dist_fn(vec_shards, rows_per)
    return nbr_fn_for, dist_fn_for


def make_pod_search_step(spec: PodIndexSpec,
                         params: Optional[SearchParams] = None, *,
                         gather_mode: str = "naive", mesh: PodMesh = None,
                         corpus_axes=None, query_spec=None):
    """Returns ``search_step(**arrays) -> (ids, dists)`` over arrays placed
    by ``place_arrays(arrays, pod_shardings(spec, mesh, corpus_axes=...),
    mesh)``: ``full_neighbors`` and ``full_vecs`` as tuples of row shards,
    the rest on the controller's device.  It runs fixed rounds
    (``spec.pilot_iters`` in stage ①, ``refine_iters + final_iters`` in
    stage ③), as the reference's dry-run step does.  ``gather_mode``
    ``naive`` moves the owners' ``(B, E, d)`` rows, ``shardwise`` their
    ``(B, E)`` distances (module docstring); both give the same bits."""
    if gather_mode not in ("naive", "shardwise"):
        raise ValueError(f"unknown gather_mode {gather_mode!r}")
    params = params or SearchParams(ef=spec.ef, ef_pilot=spec.ef_pilot,
                                    bloom_bits=spec.bloom_bits,
                                    frontier_width=spec.frontier_width,
                                    frontier_width_pilot=spec.frontier_width_pilot)

    def search_step(pilot_neighbors, pilot_vecs, pilot_scale, pilot_to_full,
                    fes_centroids, fes_entries, fes_scale, fes_entry_ids,
                    fes_valid, full_neighbors, full_vecs, queries):
        Bq = queries.shape[0]
        n_pilot = pilot_vecs.shape[0] - 1
        rows_per = full_vecs[0].shape[0]
        Np = rows_per * len(full_vecs)
        n = Np - 1
        qp = queries[:, :spec.d_primary].contiguous()
        # the side payloads engage only for the quantized encodings (the
        # *_scale slots hold the pq codebooks for "pq")
        vsc = esc = vcb = ecb = None
        if spec.pilot_dtype == "pq":
            vcb, ecb = pilot_scale, fes_scale
        elif spec.pilot_dtype in ("int8", "int4"):
            vsc, esc = pilot_scale, fes_scale

        if gather_mode == "shardwise":
            nbr_for, dist_for = make_shardwise_fns(
                mesh, corpus_axes, query_spec, Np, spec.R)
            nbr_fn, dist_fn = nbr_for(full_neighbors), dist_for(full_vecs)
        else:
            nbr_fn = shard_local_nbr_fn(full_neighbors, rows_per)
            dist_fn = (lambda q, ids, fresh=None: T.sq_dists(
                q, _gather_rows(full_vecs, ids, rows_per)))

        # ---- stage 0: FES (replicated data; K3-K5 on the card) ----
        entry_local = M.fes_entries(
            {"fes_centroids": fes_centroids, "fes_entries": fes_entries,
             "fes_entry_ids": fes_entry_ids, "fes_valid": fes_valid,
             "fes_entries_scale": esc, "fes_entries_codebook": ecb},
            params, qp)

        # ---- stage ①: pilot traversal (replicated data) ----
        spec1 = dataclasses.replace(M.pilot_spec(params), visited_mode="bloom")
        st1 = T.greedy_search(spec1, qp, pilot_neighbors, pilot_vecs, n_pilot,
                              entry_local, iters=spec.pilot_iters,
                              vec_scale=vsc, vec_codebook=vcb)
        # map pilot-compact ids to full-corpus ids
        ok = st1.cand_id < n_pilot
        cand_full = torch.where(ok, pilot_to_full[st1.cand_id.long().clamp(
            max=n_pilot)], n).to(torch.int32)

        # ---- stage ②: exact re-score (sharded scoring begins) ----
        d_full = torch.where(cand_full < n, dist_fn(queries, cand_full), INF)

        # ---- stage ③: bounded traversal on the sharded full index; the
        # positional tables are read only at the sentinel entry ----
        spec3 = T.TraversalSpec(ef=params.ef, visited_mode="bloom",
                                bloom_bits=params.bloom_bits,
                                frontier_width=params.frontier_width)
        stand_v = queries.new_zeros((1, queries.shape[1])).expand(Np, -1)
        st3 = T.greedy_search(
            spec3, queries, None, stand_v, n,
            torch.full((Bq, 1), n, dtype=torch.int32, device=queries.device),
            iters=spec.refine_iters + spec.final_iters,
            extra_id=cand_full, extra_d=d_full, nbr_fn=nbr_fn,
            dist_fn=dist_fn)
        return T.topk_from_state(st3, params.k)

    def step(**arrays):
        with torch.no_grad():
            return search_step(**arrays)
    return step


# ---------------------------------------------------------------------------
# Pod-scale serving: the sharded mutable index
# ---------------------------------------------------------------------------

#: base-index keys row-sharded under the "hot-replicated" placement; every
#: other array (pilot subgraph, quantized pilot rows + scales, FES tables,
#: coarse layer) is replicated per shard
COLD_KEYS: Tuple[str, ...] = ("full_neighbors", "rot_vecs", "residual")


@dataclass(frozen=True)
class ShardParams:
    """Pod-serving shard layout.

    placement:
      * ``hot-replicated`` — the hot pilot payload replicated on every
        shard, the cold tables (``COLD_KEYS``) row-sharded; stages ②③
        score cold rows on the shards that own them (bit-exact).
      * ``replicated`` — every table replicated, the *query batch* split
        over the shards instead (batches must divide by ``n_shards``).
    """
    n_shards: int = 1
    placement: str = "hot-replicated"   # hot-replicated | replicated

    def __post_init__(self):
        if self.placement not in ("hot-replicated", "replicated"):
            raise ValueError(f"unknown placement {self.placement!r}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")


@dataclass(frozen=True)
class ShardContext:
    """What the sharded stage pair needs beyond the arrays: the mesh, the
    shard axis, the *true* corpus size (the cold tables are padded to
    ``n_shards * rows_per`` rows) and the placement."""
    mesh: PodMesh
    axis: str
    n_shards: int
    rows_per: int
    n: int
    placement: str


class ShardHooks(NamedTuple):
    """The hooks ``pipeline.cpu_program`` scores cold rows through:
    neighbour rows, full distances and residual distances, over a corpus
    of ``n`` rows (sentinel ``n``)."""
    n: int
    nbr: Callable
    dist_full: Callable
    dist_res: Callable


def _canonical(device) -> torch.device:
    """``device`` resolved (``core/devices.py``) with its index filled in,
    so that two names of one card compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _row_shards(table: torch.Tensor, Np: int, fill, devices
                ) -> Tuple[torch.Tensor, ...]:
    """``table``'s rows padded to ``Np`` with ``fill`` rows and cut into one
    slice per device: slices within the table are views of it (no copy on
    its own device); only the slice that reaches the padding is new."""
    K = len(devices)
    rp = Np // K
    rows = table.shape[0]
    out = []
    for s, dev in enumerate(devices):
        lo, hi = s * rp, (s + 1) * rp
        part = table[min(lo, rows):min(hi, rows)]
        if hi > rows:
            pad = table.new_full((hi - max(lo, rows),) + table.shape[1:], fill)
            part = torch.cat([part, pad])
        out.append(part.to(dev))
    return tuple(out)


class ShardedSegmentedIndex(SegmentedIndex):
    """A ``core/segments.SegmentedIndex`` partitioned across devices: the
    drop-in pod-scale backend for ``serving/server.ThroughputEngine``.

    Layout (``ShardParams.placement == "hot-replicated"``):
      * base *hot* payload — replicated on every shard (``tensor.to(dev)``
        of a tensor already on ``dev`` is that tensor: shards that share a
        device share one copy);
      * base *cold* tables (``COLD_KEYS``) — row-sharded, rows padded to a
        multiple of the shard count (pad adjacency rows hold the sentinel;
        pad vectors are zeros and never scored);
      * delta segments — whole segments owned round-robin by shards, each
        on its owner's device, merged exactly in the global id space;
      * tombstones — the base's in-place bitmaps (or, with dead shards, an
        overlay), passed to the stage pair as arguments.

    Searches run ``pipeline.split_stages(shard_ctx=...)``; results are
    bit-identical to the single-device ``SegmentedIndex`` at every shard
    count (module docstring).  The base is built on the first shard's
    device; mutation plumbing (global ids, tombstones, repair, compaction)
    is inherited, and only placement and the base search path are
    overridden.

    ``devices``: one per shard (default the first ``n_shards`` CUDA
    devices).  Shards may share a device: ``["cuda:0"] * K`` runs K shards
    on one card, ``["cpu"] * K`` on the CPU.
    """

    def __init__(self, cfg, vectors, update_params=None, *,
                 shard_params: Optional[ShardParams] = None,
                 devices=None):
        sp = shard_params or ShardParams()
        if devices is None:
            have = (torch.cuda.device_count() if torch.cuda.is_available()
                    else 0)
            devices = [f"cuda:{i}" for i in range(min(have, sp.n_shards))]
        if len(devices) < sp.n_shards:
            raise ValueError(
                f"need {sp.n_shards} devices, have {len(devices)} (hint: "
                f"shards may share a device: devices=['cuda:0'] * "
                f"{sp.n_shards} runs them on one card, ['cpu'] * "
                f"{sp.n_shards} on the CPU)")
        self.sp = sp
        self.devices = [_canonical(d) for d in devices[:sp.n_shards]]
        self.mesh = PodMesh(self.devices, ("shard",))
        self._shard_open: Dict[int, DeltaSegment] = {}
        self._target_shard: Optional[int] = None
        self._rr = 0
        self._stage_cache: "OrderedDict" = OrderedDict()
        # degraded mode: shards declared dead by the serving layer's
        # HeartbeatMonitor; their rows are masked out of the search by a
        # tombstone OVERLAY (set_dead_shards) — nothing is recompiled, so
        # clearing the set restores bit-parity at once
        self._dead_shards: frozenset = frozenset()
        self._tomb_deg = self._ptomb_deg = None
        super().__init__(cfg, vectors, update_params, device=self.devices[0])
        self._install_shard_arrays()

    # -- placement ----------------------------------------------------
    def _install_shard_arrays(self) -> None:
        """(Re)lay the base arrays out per shard (each key a tuple of K
        tensors in shard order): hot keys replicated, cold keys
        row-sharded under "hot-replicated" placement."""
        base = self.base
        n = base.n
        K = self.sp.n_shards
        Np = _round_to(n + 1, K)
        hot_repl = self.sp.placement == "hot-replicated"
        arrs: Dict[str, Tuple[torch.Tensor, ...]] = {}
        for k, v in base.arrays.items():
            if k in ("tombstone", "pilot_tombstone"):
                continue                     # ride as stage arguments
            if hot_repl and k in COLD_KEYS:
                fill = n if k == "full_neighbors" else 0
                arrs[k] = _row_shards(v, Np, fill, self.devices)
            else:
                arrs[k] = tuple(v.to(d) for d in self.devices)
        self._shard_arrays = arrs
        self._shard_ctx = ShardContext(
            mesh=self.mesh, axis="shard", n_shards=K, rows_per=Np // K, n=n,
            placement=self.sp.placement)
        self._stage_cache.clear()
        self._refresh_degraded_tombs()

    def _install_base_tombstones(self) -> None:
        super()._install_base_tombstones()
        if hasattr(self, "_shard_ctx"):      # not from super().__init__
            self._refresh_degraded_tombs()

    def shard_tombs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(pilot_tombstone, tombstone)`` on the primary device — the
        REQUIRED trailing arguments of the sharded stage pair.  With dead
        shards (``set_dead_shards``) the bitmaps carry the overlay, so the
        compiled stages serve survivors-only results with no new
        capture."""
        if self._dead_shards:
            return self._ptomb_deg, self._tomb_deg
        A = self.base.arrays
        return A["pilot_tombstone"], A["tombstone"]

    # -- degraded mode --------------------------------------------------
    @property
    def dead_shards(self) -> frozenset:
        return self._dead_shards

    def set_dead_shards(self, dead) -> float:
        """Enter or leave degraded mode: mask every base row owned by a
        shard in ``dead`` (and skip its delta segments) through a tombstone
        overlay.  The same compiled stages then serve stage-①-guided,
        exactly re-scored results from the surviving shards only — the bits
        of a single-device index with those rows deleted.  An empty set
        heals: the overlay goes and results return to bit-parity with the
        healthy index.  Returns the fraction of live rows masked (the
        engine's ``stats["degraded_coverage"]``)."""
        dead = frozenset(int(s) for s in dead)
        for s in dead:
            if not 0 <= s < self.sp.n_shards:
                raise ValueError(f"shard {s} out of range "
                                 f"[0, {self.sp.n_shards})")
        self._dead_shards = dead
        self._refresh_degraded_tombs()
        return self.degraded_fraction()

    def _dead_base_rows(self) -> np.ndarray:
        """Bool mask over base positional rows owned by dead shards
        (ownership by padded row range: row j -> shard j // rows_per)."""
        n = self.base.n
        rp = self._shard_ctx.rows_per
        owner = np.minimum(np.arange(n) // rp, self.sp.n_shards - 1)
        return np.isin(owner, list(self._dead_shards))

    def _refresh_degraded_tombs(self) -> None:
        """(Re)build the overlay bitmaps = base tombstones OR dead-shard
        rows, derived as ``_install_base_tombstones`` derives the base pair
        (the pilot bitmap through ``keep_ids``), so degraded results equal
        the deleted-rows oracle bit for bit.  Re-run whenever the base
        bitmaps change while shards are dead."""
        if not self._dead_shards:
            self._tomb_deg = self._ptomb_deg = None
            return
        n, nk = self.base.n, self.base.n_pilot
        masked = self._base_tomb | self._dead_base_rows()
        tomb = np.zeros(n + 1, bool)
        tomb[:n] = masked
        ptomb = np.zeros(nk + 1, bool)
        ptomb[:nk] = masked[self.base.keep_ids]
        self._tomb_deg = torch.from_numpy(tomb).to(self.device)
        self._ptomb_deg = torch.from_numpy(ptomb).to(self.device)

    def degraded_fraction(self) -> float:
        """Fraction of live rows (base + delta) masked by the dead-shard
        overlay — 0.0 when healthy."""
        if not self._dead_shards:
            return 0.0
        live_base = ~self._base_tomb
        masked = int((live_base & self._dead_base_rows()).sum())
        total = int(live_base.sum())
        for seg in self.deltas:
            cnt = seg.live_count()
            total += cnt
            if getattr(seg, "shard", 0) in self._dead_shards:
                masked += cnt
        return masked / total if total else 0.0

    def _live_deltas(self) -> List[DeltaSegment]:
        """Degraded mode also leaves the delta segments of dead shards out
        of the merge (their device is unreachable)."""
        if not self._dead_shards:
            return self.deltas
        return [seg for seg in self.deltas
                if getattr(seg, "shard", 0) not in self._dead_shards]

    # -- mutation routing -------------------------------------------------
    def insert(self, vectors: np.ndarray,
               shard: Optional[int] = None) -> np.ndarray:
        """Append vectors; the batch lands in the delta segment owned by
        ``shard`` (round-robin when None).  Global ids stay monotone across
        shards, so the cross-shard merge stays a pure top-k in the global
        id space."""
        if shard is not None and not 0 <= shard < self.sp.n_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.sp.n_shards})")
        self._target_shard = shard
        try:
            return super().insert(vectors)
        finally:
            self._target_shard = None

    def _ensure_delta(self, need: int) -> DeltaSegment:
        s = self._target_shard
        if s is None:
            s = self._rr
            self._rr = (self._rr + 1) % self.sp.n_shards
        seg = self._shard_open.get(s)
        if seg is None:
            seg = self._new_delta(self.devices[s])
            seg.shard = s
            self._shard_open[s] = seg
            self.deltas.append(seg)
        seg.grow(need)
        return seg

    def shard_of_gids(self, gids) -> np.ndarray:
        """Owning shard per global id (base rows by row range, delta rows
        by segment owner; dead or unknown ids report shard 0) — the
        engine's per-shard delete routing."""
        g = np.atleast_1d(np.asarray(gids, np.int64))
        out = np.zeros(len(g), np.int32)
        rp = self._shard_ctx.rows_per
        for i, gid in enumerate(g):
            j = int(np.searchsorted(self._base_gids, gid))
            if j < len(self._base_gids) and self._base_gids[j] == gid:
                out[i] = min(j // rp, self.sp.n_shards - 1)
                continue
            for seg in self.deltas:
                jj = int(np.searchsorted(seg.gids[:seg.m], gid))
                if jj < seg.m and seg.gids[jj] == gid:
                    out[i] = getattr(seg, "shard", 0)
                    break
        return out

    def compact(self, *, replan: bool = True) -> "ShardedSegmentedIndex":
        super().compact(replan=replan)
        self._shard_open = {}
        self._rr = 0
        self._install_shard_arrays()
        return self

    # -- search --------------------------------------------------------
    def stage_pair(self, params: SearchParams, *, donate: bool = True):
        """The cached sharded stage pair for ``params`` (made once per
        (params, donate, generation), at most 8 kept; the serving engine's
        ``_build_stages`` takes it)."""
        key = (params, donate, self.generation)
        fns = self._stage_cache.get(key)
        if fns is None:
            from repro_torch.core.pipeline import split_stages
            fns = split_stages(self._shard_arrays, params, donate=donate,
                               shard_ctx=self._shard_ctx)
            self._stage_cache[key] = fns
            while len(self._stage_cache) > 8:
                self._stage_cache.popitem(last=False)
        else:
            self._stage_cache.move_to_end(key)
        return fns

    def search(self, queries, params: SearchParams, *, rotated: bool = False):
        """Sharded fan-out search, the contract of ``SegmentedIndex.search``
        (global ids, exact merge).  As in the reference, the per-stage
        distance counters are not threaded through the sharded stages: the
        standard stats keys report zeros and only ``delta_dist`` is
        filled."""
        q = (torch.as_tensor(queries, dtype=torch.float32).to(self.device)
             if rotated else self.rotate_queries(
                 np.asarray(queries, np.float32)))
        qp, B = pad_to_bucket(q, self.base.batch_buckets)
        pilot, cpu = self.stage_pair(params, donate=False)
        ptomb, tomb = self.shard_tombs()
        ids, dists = cpu(qp, *pilot(qp, ptomb), ptomb, tomb)
        gids, dd, scored = self.merge_with_deltas(
            q, ids[:B].cpu().numpy(), dists[:B].cpu().numpy(), params.k,
            params)
        zeros = np.zeros(B, np.int32)
        stats = {k: zeros for k in
                 ("fes_dist", "pilot_dist", "pilot_hops",
                  "pilot_expanded", "refine_dist", "final_dist",
                  "final_hops", "final_expanded", "total_cpu_dist")}
        stats["delta_dist"] = scored
        return gids, dd, stats
