"""Flash-attention forward (K8), hand-written CUDA for Hopper
(``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.flash_attention_tpu``
(``_flash_fwd_kernel``, pallas_call at ``flash_attention.py:90``): causal
or non-causal GQA attention with an fp32 online softmax, output in q's
dtype.  The TPU kernel's repeat of K/V over the query group, its
``Sq % 128 == 0`` assert and its whole-sequence K/V blocks are dropped: the
kernel reads the key head ``h // (H // Hkv)`` directly and masks the tail
rows and keys itself.

The wrapper launches a kernel for CUDA tensors, chosen by dtype and head
dim, and runs ``kernels/ref.flash_attention_ref`` for CPU tensors.  It
counts every launch in the counter registry (``runtime/trace.py``) as
``flash_attention`` and the tensor-core kernel's (bf16 at D 64 or 128)
as ``flash_attention_bf16``.

Bound and design (details in the source): at the RAG path's shape the
operations bound it (2·B·H·S·(S+1)·D on the bf16 tensor cores).  bf16 runs
on the tensor cores: per (b·h, 128 query rows) two warpgroups keep q in
shared memory, K/V tiles of 128 keys stream through a two-stage TMA ring,
and S = q·kᵀ and P·V are wgmma products with an fp32 online softmax
between them (P rounded to bf16 as the A operand of P·V, as the jnp model
reference rounds it).  fp32 also runs on the tensor cores, in 3xTF32: every
operand of both products is split into two TF32 parts, hi + lo, and a·b
is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (``mma.sync`` m16n8k8, fp32
accumulators), which keeps 1e-4 where one TF32 product does not; a block
of 4 warps owns 64 query rows and K/V tiles of 32 keys stream through a
two-stage ``cp.async`` ring.  So does bf16 at the head dims the bf16 kernel
is not built for (16, 32, 96: the ``reduced()`` configs' D 16 among them),
whose operands are exact in TF32 (their lo products are skipped), rounded
to bf16 once, at the store.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.runtime import trace

HEAD_DIMS = (16, 32, 64, 96, 128)            # the kernels' template D
TENSOR_CORE_HEAD_DIMS = (64, 128)            # bf16 on the tensor cores
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if its base is not 16-byte aligned (the bf16 kernel's
    tensor maps need aligned bases; a fresh allocation is)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, Hkv, D), H % Hkv == 0; one dtype,
    float32 or bfloat16.  Returns (B, Sq, H, D) in q's dtype.  Causal masks
    ``q_pos >= k_pos`` with q and k both starting at position 0.  On the
    card D must be one of ``HEAD_DIMS``."""
    if _build.on_cpu("flash attention", q, k, v):
        return flash_attention_ref(q, k, v, causal=causal)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, Sk, Hkv, D) or v.shape != k.shape or Hkv == 0
            or H % Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes one dtype of float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel is built for {HEAD_DIMS}")
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = _lib()
    rc = lib.flash_attention_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
        _DTYPES[q.dtype], B, Sq, Sk, H, Hkv, D, int(causal),
        1.0 / math.sqrt(D), _build.stream_of(q))
    _build.check(lib, rc, "flash_attention launch")
    trace.count("flash_attention")
    if q.dtype == torch.bfloat16 and D in TENSOR_CORE_HEAD_DIMS:
        trace.count("flash_attention_bf16")
    return o

