"""Expand-merge: score pre-gathered neighbours and merge them into the
beam, hand-written CUDA for Hopper (``csrc/topk.cu``, sort in
``csrc/sort.cuh``).

Replaces ``repro.kernels.topk_kernel.fused_expand_merge``
(``_expand_merge_kernel``, pallas_call at ``topk_kernel.py:122``).  No
search path calls it, in the reference or here (the traversal kernels do
their own merge); ``chip_smoke.py`` holds it against its plain version at
stage-① shapes.

The wrapper runs the kernel for CUDA tensors and ``kernels/ref.
expand_merge_ref`` for CPU tensors; it counts its launches in the
counter registry (``runtime/trace.py``) as ``fused_expand_merge``.

Bound and design (details in the source): bytes, dominated by the
(B, R, d) neighbour rows.  One block per query: one warp per candidate
sums in ``ref.lane_dot``'s order, so kernel and plain version give the
same bits, every row's loads in flight before any sum.  Where R <= 32 and
the beam is sorted by (distance, id), as the reference's contract has it,
one warp sorts the candidates in registers and every item is written
straight to its rank in the merged list (binary searches of the two sorted
lists); otherwise the ef + R items are sorted by (distance, id, position)
in shared memory and the first ef written out.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import expand_merge_ref
from repro_torch.runtime import trace

# neighbour-vector encoding codes (``Enc`` in csrc/topk.cu)
_ENCODINGS = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("topk")
    if lib.expand_merge.argtypes is None:
        lib.expand_merge_smem_bytes.restype = ctypes.c_size_t
        lib.expand_merge_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.expand_merge_smem_limit.restype = ctypes.c_size_t
        lib.expand_merge_smem_limit.argtypes = []
        lib.expand_merge.restype = ctypes.c_int
        lib.expand_merge.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                                     + [ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def fused_expand_merge(q: torch.Tensor, nvecs: torch.Tensor,
                       nids: torch.Tensor, fresh: torch.Tensor,
                       beam_id: torch.Tensor, beam_d: torch.Tensor,
                       beam_ck: torch.Tensor, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, d) fp32; nvecs (B, R, d) fp32 or bf16 (the kernel widens bf16
    by its bits, as the plain version's ``.float()`` does); nids (B, R)
    int32; fresh (B, R) bool; beam_* (B, ef) beam.  Returns the merged
    (ids, dists, checked) (B, ef).  Candidates that are not fresh enter as
    (BIG, id n, checked)."""
    if _build.on_cpu("expand merge", q, nvecs, nids, fresh, beam_id, beam_d,
                     beam_ck):
        return expand_merge_ref(q, nvecs, nids, fresh, beam_id, beam_d,
                                beam_ck, n)
    B, d = q.shape
    R = nids.shape[1]
    ef = beam_id.shape[1]
    if (nvecs.shape != (B, R, d) or nids.shape != (B, R)
            or fresh.shape != (B, R) or beam_d.shape != (B, ef)
            or beam_ck.shape != (B, ef)):
        raise ValueError(f"shapes q {tuple(q.shape)}, nvecs "
                         f"{tuple(nvecs.shape)}, nids {tuple(nids.shape)}, "
                         f"beam {tuple(beam_id.shape)}")
    if nvecs.dtype not in _ENCODINGS:
        raise TypeError(f"neighbour vectors must be float32|bfloat16, got "
                        f"{nvecs.dtype}")
    lib = _lib()
    W = _build.next_pow2(ef + R)
    smem = lib.expand_merge_smem_bytes(W, d)
    limit = lib.expand_merge_smem_limit()
    if smem > limit:
        raise ValueError(f"ef + R = {ef + R} at d = {d} needs {smem} B of "
                         f"shared memory per query (> {limit})")
    qf = q.float().contiguous()
    nv = nvecs.contiguous()
    ni = nids.to(torch.int32).contiguous()
    fr = fresh.to(torch.bool).contiguous()
    bid = beam_id.to(torch.int32).contiguous()
    bd = beam_d.float().contiguous()
    bck = beam_ck.to(torch.bool).contiguous()
    oid, od, ock = torch.empty_like(bid), torch.empty_like(bd), torch.empty_like(bck)
    if B == 0 or ef == 0:
        return oid, od, ock
    rc = lib.expand_merge(_build.ptr(qf), _build.ptr(nv),
                          _ENCODINGS[nv.dtype],
                          *(_build.ptr(t) for t in
                            (ni, fr, bid, bd, bck, oid, od, ock)),
                          B, d, R, ef, n, W, _build.stream_of(qf))
    _build.check(lib, rc, "expand_merge launch")
    trace.count("fused_expand_merge")
    return oid, od, ock

