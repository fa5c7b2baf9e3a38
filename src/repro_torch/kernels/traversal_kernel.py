"""Stage-① pilot traversal kernels: the per-hop round and the persistent
whole search, hand-written CUDA for Hopper (``csrc/traversal.cu``).

Replaces ``repro.kernels.traversal_kernel``: ``fused_traversal_hop``
(``_hop_kernel``, pallas_call at ``traversal_kernel.py:486``) and
``fused_pilot_search`` (``_persistent_kernel``, pallas_call at ``:565``),
dense fp32 encoding.  The bf16/int8/int4/pq branches wait for ROADMAP A5.

Both wrappers run the kernel for CUDA tensors and the plain version beside
it (``kernels/ref.py``) for CPU tensors; there is no fallback from one to the
other.  Each counts its launches in ``<wrapper>.launches``.

Bound and design (details in the source): bytes — the neighbour-id rows of
the expanded candidates and the vector rows of the fresh ones, plus the
beam and filter in and out, over 3.35 TB/s.  One block per query keeps the
beam, the packed filter and the merge buffers in shared memory, so only
those gathers touch device memory; what remains per round is latency.

Dropped TPU workarounds: one-hot-matmul gathers, the ``n < 2**24`` id cap,
whole-table BlockSpecs, 128-lane visited padding and the BIG <-> +inf
mapping (the kernel sorts +inf directly).

Precondition (as for every producer of a beam in this package): the beam is
distance-sorted, ascending, with sentinels (+inf) last.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pilot_search_ref, traversal_hop_ref


def _lib():
    lib = _build.load("traversal")
    if lib.pilot_traversal.argtypes is None:
        lib.pilot_traversal_smem_bytes.restype = ctypes.c_size_t
        lib.pilot_traversal_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.pilot_traversal_smem_limit.restype = ctypes.c_size_t
        lib.pilot_traversal_smem_limit.argtypes = []
        lib.pilot_traversal.restype = ctypes.c_int
        lib.pilot_traversal.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return lib


def _launch(q, nbr_table, vec_table, beam_id, beam_d, beam_ck, visited,
            n: int, *, width: int, visited_mode: str, rounds: int,
            want_fresh: bool):
    Bq, dp = q.shape
    N1, R = nbr_table.shape
    ef = beam_id.shape[1]
    vbits = visited.shape[1]
    if visited_mode not in ("bloom", "exact"):
        raise ValueError(f"visited_mode must be bloom|exact, got {visited_mode!r}")
    if vec_table.dtype != torch.float32:
        raise NotImplementedError("only dense fp32 vector tables are ported "
                                  "(quantized pilots: ROADMAP A5)")
    if nbr_table.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"neighbour table must be int16|int32, got {nbr_table.dtype}")
    if vec_table.shape != (N1, dp) or N1 < n + 1:
        raise ValueError(f"tables must be (n+1, R) / (n+1, dp) with n={n}: "
                         f"{tuple(nbr_table.shape)}, {tuple(vec_table.shape)}")
    if not (nbr_table.is_contiguous() and vec_table.is_contiguous()):
        raise ValueError("neighbour and vector tables must be contiguous")
    if visited_mode == "exact" and vbits != n + 1:
        raise ValueError(f"exact visited bitmap must have n+1={n + 1} bits, got {vbits}")
    if width < 1 or rounds < 0:
        raise ValueError(f"width >= 1 and rounds >= 0, got {width}, {rounds}")
    lib = _lib()
    smem = lib.pilot_traversal_smem_bytes(dp, ef, width, R, vbits)
    limit = lib.pilot_traversal_smem_limit()
    if smem > limit:
        raise ValueError(f"traversal state needs {smem} B of shared memory per "
                         f"query (> {limit}): shrink ef/width or use the "
                         f"bloom filter instead of an exact bitmap of {vbits} bits")

    dev = q.device
    q = q.float().contiguous()
    bid = beam_id.to(torch.int32).contiguous()
    bd = beam_d.float().contiguous()
    bck = beam_ck.to(torch.bool).contiguous()
    vis = visited.to(torch.bool).contiguous()
    oid = torch.empty_like(bid)
    od = torch.empty_like(bd)
    ock = torch.empty_like(bck)
    ovis = torch.empty_like(vis)
    fresh = (torch.zeros((Bq, width * R), dtype=torch.bool, device=dev)
             if want_fresh else None)
    cnt = (None if want_fresh
           else torch.zeros((Bq, 3), dtype=torch.int32, device=dev))
    if Bq == 0:
        return oid, od, ock, ovis, fresh, cnt
    null = ctypes.c_void_p(0)
    rc = lib.pilot_traversal(
        _build.ptr(q), _build.ptr(nbr_table), nbr_table.element_size(),
        _build.ptr(vec_table), _build.ptr(bid), _build.ptr(bd),
        _build.ptr(bck), _build.ptr(vis), _build.ptr(oid), _build.ptr(od),
        _build.ptr(ock), _build.ptr(ovis),
        _build.ptr(fresh) if fresh is not None else null,
        _build.ptr(cnt) if cnt is not None else null,
        Bq, dp, n, R, ef, width, vbits, int(visited_mode == "exact"), rounds,
        _build.stream_of(q))
    _build.check(lib, rc, "pilot_traversal launch")
    return oid, od, ock, ovis, fresh, cnt


def fused_traversal_hop(q: torch.Tensor, nbr_table: torch.Tensor,
                        vec_table: torch.Tensor, beam_id: torch.Tensor,
                        beam_d: torch.Tensor, beam_ck: torch.Tensor,
                        visited: torch.Tensor, n: int, *, width: int = 1,
                        visited_mode: str = "bloom"
                        ) -> Tuple[torch.Tensor, ...]:
    """One W-wide expansion round.

    q (B, dp) fp32; nbr_table (n+1, R) int16/int32 with sentinel row n;
    vec_table (n+1, dp) fp32 with a zero row at n; beam_* (B, ef) sorted
    beam (+inf sentinel distances); visited (B, n_bits) bloom filter or
    (B, n+1) exact bitmap.  Returns ``(new_id, new_d, new_ck, new_visited,
    fresh)`` with fresh (B, W·R) — the semantics of
    ``core.traversal.expansion_round`` minus the counters."""
    if _build.on_cpu("traversal", q, nbr_table, vec_table, beam_id, beam_d,
                     beam_ck, visited):
        return traversal_hop_ref(q, nbr_table, vec_table, beam_id, beam_d,
                                 beam_ck, visited, n, width=width,
                                 visited_mode=visited_mode)
    oid, od, ock, ovis, fresh, _ = _launch(
        q, nbr_table, vec_table, beam_id, beam_d, beam_ck, visited, n,
        width=width, visited_mode=visited_mode, rounds=1, want_fresh=True)
    fused_traversal_hop.launches += int(q.shape[0] > 0)
    return oid, od, ock, ovis, fresh


def fused_pilot_search(q: torch.Tensor, nbr_table: torch.Tensor,
                       vec_table: torch.Tensor, beam_id: torch.Tensor,
                       beam_d: torch.Tensor, beam_ck: torch.Tensor,
                       visited: torch.Tensor, n: int, *, rounds: int,
                       width: int = 1, visited_mode: str = "bloom"
                       ) -> Tuple[torch.Tensor, ...]:
    """Persistent stage-① search: up to ``rounds`` W-wide expansion rounds
    in one launch, each query's block exiting once its beam has no
    unchecked entry.  Inputs as ``fused_traversal_hop``.  Returns
    ``(beam_id, beam_d, beam_ck, visited, n_dist, n_hops, n_exp)`` with the
    three counters as (B,) int32 deltas over the executed rounds."""
    if _build.on_cpu("traversal", q, nbr_table, vec_table, beam_id, beam_d,
                     beam_ck, visited):
        return pilot_search_ref(q, nbr_table, vec_table, beam_id, beam_d,
                                beam_ck, visited, n, rounds=rounds,
                                width=width, visited_mode=visited_mode)
    oid, od, ock, ovis, _, cnt = _launch(
        q, nbr_table, vec_table, beam_id, beam_d, beam_ck, visited, n,
        width=width, visited_mode=visited_mode, rounds=rounds,
        want_fresh=False)
    fused_pilot_search.launches += int(q.shape[0] > 0)
    return oid, od, ock, ovis, cnt[:, 0], cnt[:, 1], cnt[:, 2]


fused_traversal_hop.launches = 0
fused_pilot_search.launches = 0
