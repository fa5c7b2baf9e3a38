"""NN-descent candidate merge, hand-written CUDA for Hopper
(``csrc/build.cu``).

Replaces ``repro.kernels.build_kernel.fused_candidate_merge``
(``_candidate_merge_kernel``, pallas_call at ``build_kernel.py:96``).  The
reference's ``MAX_ID_EXACT`` cap (ids as fp32 sort keys, n < 2**24) is a
TPU artefact and is dropped: the CUDA kernel keys on the int32 id itself.

The wrapper runs the kernel for CUDA tensors and ``kernels/ref.
candidate_merge_ref`` for CPU tensors; it counts its launches in the
counter registry (``runtime/trace.py``) as ``fused_candidate_merge``.

Bound and design (details in the source): bytes — 8·(2K + P) per row.  One
warp per row orders and dedupes its K incumbents; when they hold K distinct
valid ids the K-th (distance, id) key is a threshold, and only the
proposals below it are merged (in NN-descent's late rounds, few).  With
sentinel incumbents every proposal is merged.  Bit-equal to the plain
version: the merge does no arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import candidate_merge_ref
from repro_torch.runtime import trace


def _lib():
    lib = _build.load("build")
    if lib.candidate_merge.argtypes is None:
        lib.candidate_merge_max_width.restype = ctypes.c_int
        lib.candidate_merge_max_width.argtypes = []
        lib.candidate_merge.restype = ctypes.c_int
        lib.candidate_merge.argtypes = ([ctypes.c_void_p] * 6
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
    return lib


def fused_candidate_merge(cand_ids: torch.Tensor, cand_d: torch.Tensor,
                          prop_ids: torch.Tensor, prop_d: torch.Tensor,
                          n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cand_ids/cand_d (B, K) incumbent lists (sentinel id >= n, BIG);
    prop_ids/prop_d (B, P) scored proposals; int32 ids, fp32 distances.
    Returns the merged (ids, d) (B, K): ids >= n dropped, one copy of each
    id at its smallest distance, (distance, id) ascending, sentinel slots
    (n, BIG)."""
    if _build.on_cpu("candidate merge", cand_ids, cand_d, prop_ids, prop_d):
        return candidate_merge_ref(cand_ids, cand_d, prop_ids, prop_d, n)
    B, K = cand_ids.shape
    P = prop_ids.shape[1]
    if (cand_d.shape != (B, K) or prop_ids.dim() != 2
            or prop_ids.shape[0] != B or prop_d.shape != (B, P)):
        raise ValueError(f"shapes {tuple(cand_ids.shape)}, {tuple(cand_d.shape)}, "
                         f"{tuple(prop_ids.shape)}, {tuple(prop_d.shape)}")
    lib = _lib()
    W = _build.next_pow2(K + P)
    if W > lib.candidate_merge_max_width():
        raise ValueError(f"K + P = {K + P} exceeds the merge's list width "
                         f"{lib.candidate_merge_max_width()}")
    ci = cand_ids.to(torch.int32).contiguous()
    cd = cand_d.to(torch.float32).contiguous()
    pi = prop_ids.to(torch.int32).contiguous()
    pd = prop_d.to(torch.float32).contiguous()
    oid = torch.empty((B, K), dtype=torch.int32, device=ci.device)
    od = torch.empty((B, K), dtype=torch.float32, device=ci.device)
    if B == 0 or K == 0:
        return oid, od
    rc = lib.candidate_merge(_build.ptr(ci), _build.ptr(cd), _build.ptr(pi),
                             _build.ptr(pd), _build.ptr(oid), _build.ptr(od),
                             B, K, P, n, W, _build.stream_of(ci))
    _build.check(lib, rc, "candidate_merge launch")
    trace.count("fused_candidate_merge")
    return oid, od

