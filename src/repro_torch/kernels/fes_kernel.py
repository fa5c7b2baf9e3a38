"""Fast Entry Selection distances (paper Algorithm 2), hand-written CUDA for
Hopper (``csrc/fes.cu``).

Replaces ``repro.kernels.fes_kernel.fes_distances`` (``_fes_tile_kernel``,
pallas_call at ``fes_kernel.py:157``), dense fp32 entries.  The int4
(``_fes_int4_kernel``) and pq (``_fes_pq_kernel``) branches wait for
ROADMAP A5.

The wrapper runs the kernel for CUDA tensors and ``kernels/ref.
fes_distances_ref`` for CPU tensors; it counts its launches in
``fes_distances.launches``.

Bound and design (details in the source): at the main path's shape the
bytes (dominated by the (r, QC, C) output) bound it slightly above the fp32
non-tensor arithmetic; one block computes a 64 x 64 output tile over the
whole of d, staging both inputs through shared memory, and writes each
output once.  Plain fp32 FMA — no TF32, which would break id parity of
the top-L selection with the reference.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fes_distances_ref


def _lib():
    lib = _build.load("fes")
    if lib.fes_distances.argtypes is None:
        lib.fes_distances.restype = ctypes.c_int
        lib.fes_distances.argtypes = ([ctypes.c_void_p] * 3 +
                                      [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return lib


def fes_distances(q_grouped: torch.Tensor,
                  entries: torch.Tensor) -> torch.Tensor:
    """q_grouped (r, QC, d) cluster-grouped (padded) queries; entries
    (r, C, d) cluster-bucketed entry vectors, fp32.  Returns squared
    distances (r, QC, C), fp32, as ``qn + en − 2·dot``.  Any QC, C and d
    (ragged edges are masked in-kernel)."""
    if q_grouped.device != entries.device:
        raise ValueError(f"operands on {q_grouped.device} and {entries.device}")
    if q_grouped.device.type == "cpu":
        return fes_distances_ref(q_grouped, entries)
    if q_grouped.device.type != "cuda":
        raise ValueError(f"fes_distances runs on cuda or cpu, not {q_grouped.device}")
    r, QC, d = q_grouped.shape
    if entries.dim() != 3 or entries.shape[0] != r or entries.shape[2] != d:
        raise ValueError(f"shapes {tuple(q_grouped.shape)} x {tuple(entries.shape)}")
    if entries.dtype != torch.float32:
        raise NotImplementedError("only fp32 entry tables are ported "
                                  "(quantized FES entries: ROADMAP A5)")
    C = entries.shape[1]
    q = q_grouped.float().contiguous()
    e = entries.contiguous()
    out = torch.empty((r, QC, C), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.fes_distances(_build.ptr(q), _build.ptr(e), _build.ptr(out),
                           r, QC, C, d, _build.stream_of(q))
    _build.check(lib, rc, "fes_distances launch")
    fes_distances.launches += 1
    return out


fes_distances.launches = 0
