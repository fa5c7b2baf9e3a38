"""Traversal kernels: stage ①'s per-hop round and persistent whole search,
and stage ③'s persistent whole search, hand-written CUDA for Hopper
(``csrc/traversal.cu``).

Replaces ``repro.kernels.traversal_kernel``: ``fused_traversal_hop``
(``_hop_kernel``, pallas_call at ``traversal_kernel.py:486``) and
``fused_pilot_search`` (``_persistent_kernel``, pallas_call at ``:565``),
with every vector-table encoding of ``core/quant.py``: fp32, bf16 and int8
(dense, with an optional per-dim scale), nibble-packed int4 (scale row
wider than the stored rows; queries and scale padded to 2·hp here, as the
reference's ``_encoding_operands`` pads them) and pq codes (codebook; the
kernel builds the per-query lookup table).

Every wrapper runs the kernel for CUDA tensors and the plain version beside
it (``kernels/ref.py``) for CPU tensors; there is no fallback from one to the
other.  Each counts its launches in the counter
registry (``runtime/trace.py``) under its name.

``fused_final_search`` is ``fused_pilot_search`` with stage ③'s operands
(the full graph, int32, and the full fp32 vectors): the same round body and
loop, launched through an entry of its own (``final_traversal_kernel``), so
that a trace and the launch counters keep stage ①'s kernel (its name holds
``pilot_traversal``) apart from stage ③'s.  ``launch_smem`` gives from the
shapes alone, on the host, the shared memory a launch's state takes
(``core/traversal.takes_final_kernel`` asks it before any capture).

Bound and design (details in the source): bytes — the neighbour-id rows of
the expanded candidates and the encoded vector rows of the fresh ones
(``quant.encoded_row_bytes``), plus the beam and filter in and out, over
3.35 TB/s.  One block per query keeps the beam, the packed filter and the
merge buffers in shared memory, so only those gathers touch device memory;
what remains per round is latency, which the round body cuts to two
dependent gathers (the neighbour ids, then every candidate's row at once
into a shared-memory tile, overlapped with the visited test) and three
block barriers, and the filter moves in and out with 16-byte accesses.
Where the tile of W·R rows would not fit, the kernel scores the fresh rows
straight from device memory instead (one more dependent gather a round).

Deletions: both wrappers take the reference's ``tombstone=`` operand, an
optional ``(n+1,)`` bool bitmap (``_apply_tombstone`` at
``traversal_kernel.py:373``): tombstoned adjacency targets read as the
sentinel ``n`` and tombstoned beam entries as id ``n`` at ``+inf``.  The
kernel tests each neighbour id's byte where it reads the id and masks the
beam as it loads it (then sorts it again, stably), so no copy of the table
is made; the plain versions mask the table and the beam.  ``None`` is the
operand-free call, and an all-false bitmap gives its result bit for bit.

Dropped TPU workarounds: one-hot-matmul gathers, the ``n < 2**24`` id cap,
whole-table BlockSpecs, 128-lane visited padding and the BIG <-> +inf
mapping (the kernel sorts +inf directly).

Precondition (as for every producer of a beam in this package): the beam is
distance-sorted, ascending, with sentinels (+inf) last.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (pad_query, pad_scale, pilot_search_ref,
                                     traversal_hop_ref)
from repro_torch.runtime import trace

# kernel encoding codes (``Enc`` in csrc/traversal.cu)
ENCODINGS = ("float32", "bfloat16", "int8", "int4", "pq")
_DENSE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


# the C entry point of each stage's kernel (``TRAVERSAL_ENTRY`` in
# csrc/traversal.cu)
_ENTRIES = ("pilot_traversal", "final_traversal")


def _lib():
    lib = _build.load("traversal")
    if lib.pilot_traversal.argtypes is None:
        lib.pilot_traversal_smem_bytes.restype = ctypes.c_size_t
        lib.pilot_traversal_smem_bytes.argtypes = [ctypes.c_int] * 9
        lib.pilot_traversal_smem_limit.restype = ctypes.c_size_t
        lib.pilot_traversal_smem_limit.argtypes = []
        for entry in _ENTRIES:
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
                + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return lib


def encoding_operands(q: torch.Tensor, vec_table: torch.Tensor,
                      vec_scale: Optional[torch.Tensor],
                      vec_codebook: Optional[torch.Tensor]):
    """Classify the stored table and build the kernel's operands:
    ``(encoding name, q (B, dq) fp32, scale (dq,) fp32 or None, codebook
    (dp, m·ksub) fp32 or None, ksub)``.  Raises on a table the kernel does
    not take."""
    dp = q.shape[1]
    enc = quant.table_encoding(vec_table, vec_scale, codebook=vec_codebook)
    q = q.float()
    if enc == "pq":
        m = vec_table.shape[1]
        cb = vec_codebook.float().contiguous()
        if (vec_table.dtype != torch.int8 or cb.dim() != 2 or cb.shape[0] != dp
                or cb.shape[1] % m):
            raise ValueError(f"pq: codes (n+1, m) int8 and codebook (dp, m·ksub)"
                             f" with dp={dp}; got {tuple(vec_table.shape)} "
                             f"{vec_table.dtype}, {tuple(cb.shape)}")
        return "pq", q.contiguous(), None, cb, cb.shape[1] // m
    if vec_scale is not None and (vec_scale.dim() != 1 or vec_scale.shape[0] != dp):
        raise ValueError(f"scale must be ({dp},), got {tuple(vec_scale.shape)}")
    if enc == "int4":
        if vec_table.dtype != torch.int8 or 2 * vec_table.shape[1] - dp not in (0, 1):
            raise ValueError(f"int4 tables are (n+1, ceil(dp/2)) packed int8 with "
                             f"dp={dp}, got {tuple(vec_table.shape)} {vec_table.dtype}")
        return ("int4", pad_query(q, vec_table, vec_scale).contiguous(),
                pad_scale(vec_scale, vec_table).contiguous(), None, 0)
    if vec_table.dtype not in _DENSE:
        raise TypeError(f"vector table must be float32|bfloat16|int8, got "
                        f"{vec_table.dtype}")
    if vec_table.shape[1] != dp:
        raise ValueError(f"vector rows of width {vec_table.shape[1]} for "
                         f"queries of width {dp}")
    scale = None if vec_scale is None else vec_scale.float().contiguous()
    return (ENCODINGS[_DENSE[vec_table.dtype]], q.contiguous(), scale, None, 0)


# the most shared memory a block may take (``kSmemLimit``), and the
# threads of a block (``kThreads``), in csrc/traversal.cu
SMEM_LIMIT = 232448
_THREADS = 256


def _align16(x: int) -> int:
    return (x + 15) & ~15


@lru_cache(maxsize=None)
def smem_bytes(dq: int, ef: int, W: int, R: int, vbits: int, has_scale: bool,
               lut_width: int, row_bytes: int) -> int:
    """Shared memory of one block, in the layout a launch takes: with the
    tile of the round's W·R encoded rows where that fits ``SMEM_LIMIT``,
    else without it.  ``choose_layout`` of csrc/traversal.cu computed on the
    host (the card tests hold the two equal), so that a shape can be judged
    without the card."""
    WR = W * R

    def total(stride: int) -> int:
        parts = ([4 * dq, 4 * dq if has_scale else 0, 4 * lut_width]
                 + [4 * ef] * 6 + [4 * ((vbits + 31) // 32 + 1),
                                   4 * W * (_THREADS // 32)]
                 + [4 * WR] * 5 + [WR * stride, 16])
        return sum(_align16(p) for p in parts)

    tiled = total(_align16(row_bytes))
    return tiled if tiled <= SMEM_LIMIT else total(0)


def launch_smem(vec_table: torch.Tensor, *, ef: int, width: int, R: int,
                vbits: int, vec_scale: Optional[torch.Tensor] = None,
                vec_codebook: Optional[torch.Tensor] = None) -> int:
    """``smem_bytes`` of a launch over ``vec_table`` (its decoded row width,
    scale row, pq lookup table and stored row bytes) with a beam of ``ef``,
    W ``width``, ``R`` neighbours a row and a filter of ``vbits`` bits.
    Reads shapes and dtypes only."""
    enc = quant.table_encoding(vec_table, vec_scale, codebook=vec_codebook)
    row_bytes = vec_table.shape[1] * vec_table.element_size()
    if enc == "pq":
        dq, lut_width = vec_codebook.shape
    else:
        dq = 2 * vec_table.shape[1] if enc == "int4" else vec_table.shape[1]
        lut_width = 0
    return smem_bytes(dq, ef, width, R, vbits, vec_scale is not None,
                      lut_width, row_bytes)


def check_tombstone(tombstone: Optional[torch.Tensor], n: int) -> None:
    """Raise unless ``tombstone`` is None or an ``(n+1,)`` contiguous bool
    bitmap (the kernel reads one byte per id)."""
    if tombstone is None:
        return
    if (tombstone.dtype != torch.bool or tombstone.dim() != 1
            or tombstone.shape[0] != n + 1 or not tombstone.is_contiguous()):
        raise ValueError(f"tombstone must be a contiguous ({n + 1},) bool "
                         f"bitmap, got {tuple(tombstone.shape)} "
                         f"{tombstone.dtype}")


def _launch(q, nbr_table, vec_table, beam_id, beam_d, beam_ck, visited,
            n: int, *, width: int, visited_mode: str, rounds: int,
            want_fresh: bool, vec_scale=None, vec_codebook=None,
            tombstone=None, entry: str = "pilot_traversal"):
    Bq = q.shape[0]
    N1, R = nbr_table.shape
    ef = beam_id.shape[1]
    vbits = visited.shape[1]
    if visited_mode not in ("bloom", "exact"):
        raise ValueError(f"visited_mode must be bloom|exact, got {visited_mode!r}")
    if nbr_table.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"neighbour table must be int16|int32, got {nbr_table.dtype}")
    if vec_table.shape[0] != N1 or N1 < n + 1:
        raise ValueError(f"tables must have n+1={n + 1} rows: "
                         f"{tuple(nbr_table.shape)}, {tuple(vec_table.shape)}")
    if not (nbr_table.is_contiguous() and vec_table.is_contiguous()):
        raise ValueError("neighbour and vector tables must be contiguous")
    if visited_mode == "exact" and vbits != n + 1:
        raise ValueError(f"exact visited bitmap must have n+1={n + 1} bits, got {vbits}")
    if width < 1 or rounds < 0:
        raise ValueError(f"width >= 1 and rounds >= 0, got {width}, {rounds}")
    check_tombstone(tombstone, n)
    enc, qk, scale, cb, ksub = encoding_operands(q, vec_table, vec_scale,
                                                 vec_codebook)
    smem = launch_smem(vec_table, ef=ef, width=width, R=R, vbits=vbits,
                       vec_scale=vec_scale, vec_codebook=vec_codebook)
    if smem > SMEM_LIMIT:
        raise ValueError(f"traversal state needs {smem} B of shared memory per "
                         f"query (> {SMEM_LIMIT}): shrink ef/width or use the "
                         f"bloom filter instead of an exact bitmap of {vbits} bits")
    lib = _lib()
    dq, code = qk.shape[1], ENCODINGS.index(enc)

    dev = q.device
    bid = beam_id.to(torch.int32).contiguous()
    bd = beam_d.float().contiguous()
    bck = beam_ck.to(torch.bool).contiguous()
    vis = visited.to(torch.bool).contiguous()
    oid = torch.empty_like(bid)
    od = torch.empty_like(bd)
    ock = torch.empty_like(bck)
    ovis = torch.empty_like(vis)
    # the kernel writes both whole
    fresh = (torch.empty((Bq, width * R), dtype=torch.bool, device=dev)
             if want_fresh else None)
    cnt = (None if want_fresh
           else torch.empty((Bq, 3), dtype=torch.int32, device=dev))
    if Bq == 0:
        return oid, od, ock, ovis, fresh, cnt
    rc = getattr(lib, entry)(
        _build.ptr(qk), _build.ptr(nbr_table), nbr_table.element_size(),
        _build.ptr(vec_table), code, vec_table.shape[1],
        _build.ptr(scale), _build.ptr(cb), ksub, _build.ptr(tombstone),
        _build.ptr(bid), _build.ptr(bd),
        _build.ptr(bck), _build.ptr(vis), _build.ptr(oid), _build.ptr(od),
        _build.ptr(ock), _build.ptr(ovis), _build.ptr(fresh), _build.ptr(cnt),
        Bq, dq, n, R, ef, width, vbits, int(visited_mode == "exact"), rounds,
        _build.stream_of(q))
    _build.check(lib, rc, f"{entry} launch")
    return oid, od, ock, ovis, fresh, cnt


def fused_traversal_hop(q: torch.Tensor, nbr_table: torch.Tensor,
                        vec_table: torch.Tensor, beam_id: torch.Tensor,
                        beam_d: torch.Tensor, beam_ck: torch.Tensor,
                        visited: torch.Tensor, n: int, *, width: int = 1,
                        visited_mode: str = "bloom",
                        vec_scale: Optional[torch.Tensor] = None,
                        vec_codebook: Optional[torch.Tensor] = None,
                        tombstone: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """One W-wide expansion round.

    q (B, dp) fp32; nbr_table (n+1, R) int16/int32 with sentinel row n;
    vec_table with a zero row at n: (n+1, dp) fp32, bf16 or int8
    (``vec_scale`` (dp,) optional), (n+1, ceil(dp/2)) int8 nibble-packed
    int4 (``vec_scale`` (dp,)), or (n+1, m) int8 pq codes
    (``vec_codebook`` (dp, m·ksub)); beam_* (B, ef) sorted
    beam (+inf sentinel distances); visited (B, n_bits) bloom filter or
    (B, n+1) exact bitmap; tombstone: optional (n+1,) bool deletion bitmap
    (module docstring).  Returns ``(new_id, new_d, new_ck, new_visited,
    fresh)`` with fresh (B, W·R) — the semantics of
    ``core.traversal.expansion_round`` minus the counters."""
    if _build.on_cpu("traversal", q, nbr_table, vec_table, beam_id, beam_d,
                     beam_ck, visited, vec_scale, vec_codebook, tombstone):
        return traversal_hop_ref(q, nbr_table, vec_table, beam_id, beam_d,
                                 beam_ck, visited, n, width=width,
                                 visited_mode=visited_mode,
                                 vec_scale=vec_scale,
                                 vec_codebook=vec_codebook,
                                 tombstone=tombstone)
    oid, od, ock, ovis, fresh, _ = _launch(
        q, nbr_table, vec_table, beam_id, beam_d, beam_ck, visited, n,
        width=width, visited_mode=visited_mode, rounds=1, want_fresh=True,
        vec_scale=vec_scale, vec_codebook=vec_codebook, tombstone=tombstone)
    trace.count("fused_traversal_hop", int(q.shape[0] > 0))
    return oid, od, ock, ovis, fresh


def _whole_search(entry: str, name: str, q, nbr_table, vec_table, beam_id,
                  beam_d, beam_ck, visited, n: int, *, rounds: int,
                  width: int, visited_mode: str, vec_scale, vec_codebook,
                  tombstone):
    """One persistent launch through the C entry point ``entry``, counted
    under ``name`` (the plain version on CPU tensors)."""
    if _build.on_cpu("traversal", q, nbr_table, vec_table, beam_id, beam_d,
                     beam_ck, visited, vec_scale, vec_codebook, tombstone):
        return pilot_search_ref(q, nbr_table, vec_table, beam_id, beam_d,
                                beam_ck, visited, n, rounds=rounds,
                                width=width, visited_mode=visited_mode,
                                vec_scale=vec_scale,
                                vec_codebook=vec_codebook,
                                tombstone=tombstone)
    oid, od, ock, ovis, _, cnt = _launch(
        q, nbr_table, vec_table, beam_id, beam_d, beam_ck, visited, n,
        width=width, visited_mode=visited_mode, rounds=rounds,
        want_fresh=False, vec_scale=vec_scale, vec_codebook=vec_codebook,
        tombstone=tombstone, entry=entry)
    trace.count(name, int(q.shape[0] > 0))
    return oid, od, ock, ovis, cnt[:, 0], cnt[:, 1], cnt[:, 2]


def fused_pilot_search(q: torch.Tensor, nbr_table: torch.Tensor,
                       vec_table: torch.Tensor, beam_id: torch.Tensor,
                       beam_d: torch.Tensor, beam_ck: torch.Tensor,
                       visited: torch.Tensor, n: int, *, rounds: int,
                       width: int = 1, visited_mode: str = "bloom",
                       vec_scale: Optional[torch.Tensor] = None,
                       vec_codebook: Optional[torch.Tensor] = None,
                       tombstone: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """Persistent stage-① search: up to ``rounds`` W-wide expansion rounds
    in one launch, each query's block exiting once its beam has no
    unchecked entry.  Inputs as ``fused_traversal_hop``.  Returns
    ``(beam_id, beam_d, beam_ck, visited, n_dist, n_hops, n_exp)`` with the
    three counters as (B,) int32 deltas over the executed rounds."""
    return _whole_search(
        "pilot_traversal", "fused_pilot_search", q, nbr_table, vec_table,
        beam_id, beam_d, beam_ck, visited, n, rounds=rounds, width=width,
        visited_mode=visited_mode, vec_scale=vec_scale,
        vec_codebook=vec_codebook, tombstone=tombstone)


def fused_final_search(q: torch.Tensor, nbr_table: torch.Tensor,
                       vec_table: torch.Tensor, beam_id: torch.Tensor,
                       beam_d: torch.Tensor, beam_ck: torch.Tensor,
                       visited: torch.Tensor, n: int, *, rounds: int,
                       width: int = 1, visited_mode: str = "bloom",
                       vec_scale: Optional[torch.Tensor] = None,
                       vec_codebook: Optional[torch.Tensor] = None,
                       tombstone: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """Persistent stage-③ search (``final_traversal_kernel``): operands,
    semantics and returns as ``fused_pilot_search``'s, over the full graph
    and vectors; its launches are counted under this name (module
    docstring)."""
    return _whole_search(
        "final_traversal", "fused_final_search", q, nbr_table, vec_table,
        beam_id, beam_d, beam_ck, visited, n, rounds=rounds, width=width,
        visited_mode=visited_mode, vec_scale=vec_scale,
        vec_codebook=vec_codebook, tombstone=tombstone)
