"""Quantized pilot payloads — port of ``repro.core.quant``.

Five encodings of the stage-① vector tables (``IndexConfig.pilot_dtype``),
the compression ladder ``ResidencyPlanner`` descends:

  * ``float32``  — identity (4 B/dim), the exact baseline.
  * ``bfloat16`` — rounding to bf16 (2 B/dim), no side data; widening back
    to fp32 is exact.
  * ``int8``     — symmetric per-dimension scale (1 B/dim + one fp32 scale
    row per table): ``data = round(x / scale)``, ``scale[j] = max_i
    |x[i, j]| / 127``; ``x̂ = data · scale``.
  * ``int4``     — the same at nibble width (``scale = amax / 7``), two dims
    per byte: dim ``j`` in the low nibble and dim ``j + ceil(d/2)`` in the
    high nibble of byte ``j``.
  * ``pq``       — m-subspace product quantization (1 code byte per
    subspace + one fp32 block-diagonal codebook ``(d, m·ksub)`` per table,
    column ``s·ksub + c`` = centroid ``c`` of subspace ``s``); distances
    come from a per-query lookup table.  Centroid 0 of every subspace is
    the zero vector, so zero rows (sentinels, padding) stay zero.

Only stage-① payloads are quantized; stage ② re-scores the pilot beam
exactly from ``rot_vecs`` when ``primary`` is not fp32
(``core/multistage.refine_stage``).

Build-time encoding is numpy on the host, as in the reference, and gives
the reference's bytes exactly.  The one exception to "numpy in, numpy out"
is bf16: numpy has no bf16 type of its own, so ``quantize(x, "bfloat16")``
returns a CPU ``torch.bfloat16`` tensor, rounded to nearest even by torch
(the rounding of the reference's ``x.astype(jnp.bfloat16)``).  Decoding
and ``pq_lut`` are torch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Encodings accepted by IndexConfig.pilot_dtype, widest first (the
# ResidencyPlanner's ladder order).
PILOT_DTYPES = ("float32", "bfloat16", "int8", "int4", "pq")

# Bytes per vector dimension of the fixed-width encodings (int4 and pq go
# through encoded_row_bytes / side_bytes).
VEC_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}

# Fidelity rank of the planner's preference ladder (higher is more exact).
FIDELITY = {"float32": 4, "bfloat16": 3, "int8": 2, "int4": 1, "pq": 0}

# Product-quantization geometry: m subspaces x ksub centroids.
PQ_M = 8
PQ_KSUB = 16
_PQ_KMEANS_ITERS = 12


def check_pilot_dtype(pilot_dtype: str) -> None:
    if pilot_dtype not in PILOT_DTYPES:
        raise ValueError(f"pilot_dtype must be one of {PILOT_DTYPES}, "
                         f"got {pilot_dtype!r}")


def pq_geometry(d: int) -> Tuple[int, int, int]:
    """(m, dsub, ksub) for a ``d``-dim table: at most ``PQ_M`` subspaces of
    ``dsub = ceil(d/min(PQ_M, d))`` dims, ``m = ceil(d/dsub)`` so only the
    last subspace is zero-padded."""
    if d < 1:
        raise ValueError(f"pq needs d >= 1, got {d}")
    dsub = -(-d // min(PQ_M, d))
    m = -(-d // dsub)
    return m, dsub, PQ_KSUB


def int4_packed_width(d: int) -> int:
    """Packed byte width of an int4 row: ``ceil(d/2)``."""
    if d < 2:
        raise ValueError(f"int4 needs d >= 2, got {d}")
    return -(-d // 2)


def encoded_row_bytes(d: int, dtype: str) -> int:
    """Bytes per encoded row of a ``d``-dim table (payload only)."""
    if dtype in VEC_ITEMSIZE:
        return d * VEC_ITEMSIZE[dtype]
    if dtype == "int4":
        return int4_packed_width(d)
    if dtype == "pq":
        return pq_geometry(d)[0]
    check_pilot_dtype(dtype)
    raise AssertionError(dtype)


def side_bytes(d: int, dtype: str) -> int:
    """Per-table side bytes: the fp32 scale row (int8/int4) or the fp32
    block-diagonal codebook (pq); zero for exact encodings."""
    if dtype in ("int8", "int4"):
        return d * 4
    if dtype == "pq":
        m, _, ksub = pq_geometry(d)
        return d * m * ksub * 4
    check_pilot_dtype(dtype)
    return 0


def _pq_kmeans(xs: np.ndarray, ksub: int, seed: int) -> np.ndarray:
    """Deterministic Lloyd's kmeans for one subspace (rows, dsub) ->
    (ksub, dsub) centroids; centroid 0 pinned to zero, empty clusters keep
    their previous centroid."""
    rng = np.random.default_rng(seed)
    rows, dsub = xs.shape
    cent = np.zeros((ksub, dsub), np.float32)
    if rows:
        pick = rng.choice(rows, size=min(rows, ksub - 1), replace=False)
        cent[1:1 + len(pick)] = xs[pick]
    for _ in range(_PQ_KMEANS_ITERS):
        d2 = ((xs[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(1)
        for c in range(1, ksub):
            sel = assign == c
            if sel.any():
                cent[c] = xs[sel].mean(0)
    return cent.astype(np.float32)


def pq_encode(x: np.ndarray, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a float32 table (..., d) as ``(codes (..., m) int8, codebook
    (d, m·ksub) fp32)``."""
    x = np.asarray(x, np.float32)
    d = x.shape[-1]
    m, dsub, ksub = pq_geometry(d)
    flat = x.reshape(-1, d)
    dpad = m * dsub
    if dpad != d:
        flat = np.concatenate(
            [flat, np.zeros((flat.shape[0], dpad - d), np.float32)], axis=1)
    codes = np.zeros(flat.shape[:1] + (m,), np.int8)
    codebook = np.zeros((d, m * ksub), np.float32)
    for s in range(m):
        lo, hi = s * dsub, (s + 1) * dsub
        xs = flat[:, lo:hi]
        cent = _pq_kmeans(xs, ksub, seed + s)
        d2 = ((xs[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
        codes[:, s] = d2.argmin(1).astype(np.int8)
        span = min(hi, d) - lo
        codebook[lo:lo + span, s * ksub:(s + 1) * ksub] = cent[:, :span].T
    return codes.reshape(x.shape[:-1] + (m,)), codebook


def quantize(x: np.ndarray, dtype: str):
    """Encode a float32 table ``x`` (..., d) as ``(data, side)``: ``side``
    is the fp32 ``(d,)`` scale row (int8/int4), the ``(d, m·ksub)`` codebook
    (pq) or None.  ``data`` is numpy, except a CPU ``torch.bfloat16`` tensor
    for bf16."""
    check_pilot_dtype(dtype)
    x = np.asarray(x, np.float32)
    if dtype == "float32":
        return x, None
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16), None
    if dtype == "pq":
        return pq_encode(x)
    d = x.shape[-1]
    amax = np.abs(x.reshape(-1, d)).max(axis=0)
    if dtype == "int8":
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        data = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        return data, scale
    scale = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
    q4 = np.clip(np.round(x / scale), -7, 7).astype(np.int8)
    return int4_pack(q4), scale


def int4_pack(codes: np.ndarray) -> np.ndarray:
    """Pack signed nibble codes (..., d) in [-8, 7] into bytes
    (..., ceil(d/2)): dim j in the low nibble and dim j+hp in the high
    nibble of byte j."""
    codes = np.asarray(codes, np.int8)
    d = codes.shape[-1]
    hp = int4_packed_width(d)
    if 2 * hp != d:
        codes = np.concatenate(
            [codes, np.zeros(codes.shape[:-1] + (2 * hp - d,), np.int8)],
            axis=-1)
    lo = codes[..., :hp].astype(np.uint8) & 0xF
    hi = codes[..., hp:].astype(np.uint8) & 0xF
    return (lo | (hi << 4)).astype(np.int8)


def int4_unpack(data, d: Optional[int] = None):
    """Unpack an int4-packed table (..., hp) to its signed nibble values
    (..., 2·hp), or (..., d) when ``d`` is given, as int32 (numpy in, numpy
    out; torch in, torch out)."""
    if isinstance(data, torch.Tensor):
        v = data.to(torch.int32)
        cat = torch.cat
    else:
        v = np.asarray(data).astype(np.int32)
        cat = np.concatenate
    lo = v & 0xF
    lo = lo - 16 * (lo >= 8)
    hi = (v >> 4) & 0xF
    hi = hi - 16 * (hi >= 8)
    out = cat([lo, hi], -1)
    return out if d is None else out[..., :d]


def table_encoding(table, side=None, *, codebook=None) -> str:
    """``pq`` with a codebook, ``int4`` with a scale row wider than the
    stored rows, else ``dense`` (fp32/bf16/int8, scaled or not)."""
    if codebook is not None:
        return "pq"
    if side is not None and table.shape[-1] < side.shape[-1]:
        return "int4"
    return "dense"


def primary_dim(table, side=None, *, codebook=None) -> int:
    """True vector width of a stored (possibly packed) table."""
    if codebook is not None:
        return codebook.shape[0]
    if side is not None:
        return side.shape[-1]
    return table.shape[-1]


def decode_rows(rows: torch.Tensor, side: Optional[torch.Tensor] = None, *,
                codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode gathered rows of any encoding to float32.  Identity for exact
    tables with no side data (the bit-exactness contract of the fp32 and
    bf16 paths: bf16 rows widen where they are used)."""
    enc = table_encoding(rows, side, codebook=codebook)
    if enc == "pq":
        cb = codebook.float()
        d = cb.shape[0]
        ksub = pq_geometry(d)[2]
        codes = rows.long()
        flat = codes.reshape(-1, codes.shape[-1])
        cols = flat + ksub * torch.arange(flat.shape[-1], device=rows.device)
        out = cb.T[cols].sum(dim=1)
        return out.reshape(codes.shape[:-1] + (d,))
    if enc == "int4":
        return int4_unpack(rows, side.shape[-1]).float() * side.float()
    if side is not None:
        return rows.float() * side.float()
    return rows


def dequantize(data, scale=None, *, codebook=None):
    """Decode to float32 (numpy in, numpy out; torch in, torch out).  A 2-D
    ``scale`` is read as the pq codebook, so ``dequantize(*quantize(x,
    dt))`` round-trips every encoding."""
    if codebook is None and scale is not None and np.ndim(scale) == 2:
        scale, codebook = None, scale
    out = decode_rows(_tensor(data), _tensor(scale),
                      codebook=_tensor(codebook)).float()
    return out if isinstance(data, torch.Tensor) else out.numpy()


def _tensor(a):
    if a is None or isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def pq_lut(q: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Per-query lookup table ``lut[b, s·ksub + c] = ‖c_s‖² − 2·q_s·c_s``,
    so that ``dist(q, x) = ‖q‖² + Σ_s lut[b, s·ksub + code_s(x)]``."""
    cb = codebook.float()
    cn = (cb * cb).sum(0)
    return cn[None, :] - 2.0 * (q.float() @ cb)


def roundtrip_error_bound(x: np.ndarray, dtype: str) -> np.ndarray:
    """Per-dimension bound on ``|x - dequantize(quantize(x))|``: half a
    step for the fixed-width encodings, the achieved error of the
    deterministic encoder for pq."""
    x = np.asarray(x, np.float32)
    amax = np.abs(x.reshape(-1, x.shape[-1])).max(axis=0)
    if dtype == "float32":
        return np.zeros_like(amax)
    if dtype == "bfloat16":
        return amax * 2.0 ** -8
    if dtype == "int8":
        return np.where(amax > 0, amax / 127.0, 1.0) * 0.5 + 1e-7
    if dtype == "int4":
        return np.where(amax > 0, amax / 7.0, 1.0) * 0.5 + 1e-6
    if dtype == "pq":
        codes, codebook = pq_encode(x)
        err = np.abs(dequantize(codes, codebook=codebook) - x)
        return err.reshape(-1, x.shape[-1]).max(axis=0) + 1e-6
    check_pilot_dtype(dtype)
    raise AssertionError(dtype)


def dequant_sq_dists(q: torch.Tensor, table: torch.Tensor,
                     scale: Optional[torch.Tensor] = None, *,
                     codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared euclidean between fp32 queries (B, d) and an encoded table
    (m, ...) -> (B, m): decode the whole table, then ``core.traversal.
    sq_dists``."""
    from repro_torch.core.traversal import sq_dists
    return sq_dists(q, decode_rows(table, scale, codebook=codebook).float())
