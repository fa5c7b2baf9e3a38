"""Fast Entry Selection distances (paper Algorithm 2), hand-written CUDA for
Hopper (``csrc/fes.cu``).

Replaces ``repro.kernels.fes_kernel.fes_distances`` and its three Pallas
kernels, one wrapper and one launch counter each:

  * ``fes_distances`` — K3 ``_fes_tile_kernel`` (pallas_call at
    ``fes_kernel.py:157``): entries fp32, bf16 or int8 with a per-dim
    scale; it hands int4 and pq entries to the two below;
  * ``fes_int4_distances`` — K4 ``_fes_int4_kernel`` (``:137``): entries
    nibble-packed int4 with the scale; the kernel reads the queries and
    the scale at their own width d (the plain version pads them to 2·hp,
    as the reference does);
  * ``fes_pq_distances`` — K5 ``_fes_pq_kernel`` (``:118``): pq codes with
    the codebook; the kernel builds each query's lookup table.

Each wrapper runs its kernel for CUDA tensors and ``kernels/ref.
fes_distances_ref`` for CPU tensors, and counts its launches in
the counter registry (``runtime/trace.py``) under the wrapper's name.

Bound and design (details in the source): the bytes, dominated by the
(r, QC, C) output, bound all three at the main path's shape, where 31 of
every 32 slots are zero rows.  A zero row's outputs need no products (they
are the entries' own norms, or the zero query's table summed), so the
kernels compute them once per entry and do products only for the occupied
slots; rows are staged with 16-byte ``cp.async`` and written with 16-byte
stores.  The pq kernel builds each slot's table once per launch, walking
the whole of C.  Plain fp32 in one fixed summation order (the contract
in the source's header), which fixes every output bit; no TF32, which
would break id parity of the top-L selection with the reference.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fes_distances_ref
from repro_torch.runtime import trace

# kernel encoding codes (``Enc`` in csrc/fes.cu)
ENCODINGS = ("float32", "bfloat16", "int8", "int4")
_DENSE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _lib():
    lib = _build.load("fes")
    if lib.fes_distances.argtypes is None:
        lib.fes_distances.restype = ctypes.c_int
        lib.fes_distances.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.fes_pq_distances.restype = ctypes.c_int
        lib.fes_pq_distances.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.fes_pq_smem_bytes.restype = ctypes.c_size_t
        lib.fes_pq_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.fes_smem_limit.restype = ctypes.c_size_t
        lib.fes_smem_limit.argtypes = []
    return lib


_PQ_SMEM: dict = {}


def _pq_smem(lib, m: int, ksub: int):
    """(shared memory one K5 block needs, the per-block limit), per
    (m, ksub), asked of the library once."""
    key = (m, ksub)
    if key not in _PQ_SMEM:
        _PQ_SMEM[key] = (lib.fes_pq_smem_bytes(m, ksub), lib.fes_smem_limit())
    return _PQ_SMEM[key]


def _check_operands(what: str, q_grouped, entries, *side) -> bool:
    """Shared checks; True when the operands lie on the CPU."""
    if _build.on_cpu(what, q_grouped, entries, *side):
        return True
    if (q_grouped.dim() != 3 or entries.dim() != 3
            or entries.shape[0] != q_grouped.shape[0]):
        raise ValueError(f"{what}: shapes {tuple(q_grouped.shape)} x "
                         f"{tuple(entries.shape)}")
    return False


def _tile_launch(q, entries, enc: int, scale, d: int) -> torch.Tensor:
    """K3/K4 on q (r, QC, d); ``d`` is the queries' (and the scale's)
    width: vw, or for int4 2·vw or 2·vw − 1."""
    r, QC, _ = q.shape
    C, vw = entries.shape[1], entries.shape[2]
    q = q.float().contiguous()
    e = entries.contiguous()
    out = torch.empty((r, QC, C), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.fes_distances(_build.ptr(q), _build.ptr(e), enc,
                           _build.ptr(scale), _build.ptr(out), r, QC, C, d,
                           vw, _build.stream_of(q))
    _build.check(lib, rc, "fes_distances launch")
    return out


def fes_distances(q_grouped: torch.Tensor, entries: torch.Tensor, *,
                  scale: Optional[torch.Tensor] = None,
                  codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q_grouped (r, QC, d) cluster-grouped (padded) queries; entries
    (r, C, d) fp32, bf16 or int8 (``scale`` (d,) optional), or — handed to
    ``fes_int4_distances`` / ``fes_pq_distances`` — nibble-packed int4
    (``scale`` (d,) wider than the rows) or pq codes (``codebook``).
    Returns squared distances (r, QC, C), fp32, as ``qn + en − 2·dot``.
    Any QC, C and d (ragged edges are masked in-kernel)."""
    if codebook is not None:
        return fes_pq_distances(q_grouped, entries, codebook)
    if scale is not None and entries.shape[-1] < scale.shape[-1]:
        return fes_int4_distances(q_grouped, entries, scale)
    if _check_operands("fes_distances", q_grouped, entries, scale):
        return fes_distances_ref(q_grouped, entries, scale=scale)
    d = q_grouped.shape[2]
    if entries.shape[2] != d:
        raise ValueError(f"entry rows of width {entries.shape[2]} for queries "
                         f"of width {d}")
    if entries.dtype not in _DENSE:
        raise TypeError(f"entries must be float32|bfloat16|int8, got {entries.dtype}")
    if scale is not None:
        scale = scale.float().contiguous()
    out = _tile_launch(q_grouped, entries, _DENSE[entries.dtype], scale, d)
    trace.count("fes_distances", int(out.numel() > 0))
    return out


def fes_int4_distances(q_grouped: torch.Tensor, entries: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """K4: entries (r, C, hp) int8 nibble-packed (``quant.int4_pack``),
    scale (d,) with hp = ceil(d/2); q_grouped (r, QC, d)."""
    if _check_operands("fes_int4_distances", q_grouped, entries, scale):
        return fes_distances_ref(q_grouped, entries, scale=scale)
    d = q_grouped.shape[2]
    width = 2 * entries.shape[2]
    if entries.dtype != torch.int8 or scale.shape != (d,) or width - d not in (0, 1):
        raise ValueError(f"int4: entries (r, C, ceil(d/2)) int8 and scale "
                         f"({d},); got {tuple(entries.shape)} {entries.dtype}, "
                         f"{tuple(scale.shape)}")
    out = _tile_launch(q_grouped, entries, ENCODINGS.index("int4"),
                       scale.float().contiguous(), d)
    trace.count("fes_int4_distances", int(out.numel() > 0))
    return out


def fes_pq_distances(q_grouped: torch.Tensor, entries: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    """K5: entries (r, C, m) int8 pq codes, codebook (d, m·ksub) fp32;
    q_grouped (r, QC, d).  Returns ``qn + Σ_s lut[s·ksub + code_s]``."""
    if _check_operands("fes_pq_distances", q_grouped, entries, codebook):
        return fes_distances_ref(q_grouped, entries, codebook=codebook)
    r, QC, d = q_grouped.shape
    C, m = entries.shape[1], entries.shape[2]
    if (entries.dtype != torch.int8 or codebook.dim() != 2
            or codebook.shape[0] != d or codebook.shape[1] % m):
        raise ValueError(f"pq: codes (r, C, m) int8 and codebook (d, m·ksub) "
                         f"with d={d}; got {tuple(entries.shape)} "
                         f"{entries.dtype}, {tuple(codebook.shape)}")
    ksub = codebook.shape[1] // m
    lib = _lib()
    smem, limit = _pq_smem(lib, m, ksub)
    if smem > limit:
        raise ValueError(f"pq lookup tables need {smem} B of shared memory per "
                         f"block (> {limit}): m·ksub = {m * ksub} is too wide")
    q = q_grouped.float().contiguous()
    e = entries.contiguous()
    cb = codebook.float().contiguous()
    out = torch.empty((r, QC, C), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    rc = lib.fes_pq_distances(_build.ptr(q), _build.ptr(e), _build.ptr(cb),
                              _build.ptr(out), r, QC, C, d, m, ksub,
                              _build.stream_of(q))
    _build.check(lib, rc, "fes_pq_distances launch")
    trace.count("fes_pq_distances")
    return out

