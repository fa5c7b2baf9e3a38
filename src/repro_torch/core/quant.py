"""Pilot payload encodings — the fp32 slice of ``repro.core.quant``.

The reference offers five stage-① encodings (float32, bfloat16, int8, int4,
pq).  This port carries the exact one only: ``decode_rows`` is the identity
for exact tables, which is what keeps the fp32 path bit-exact.  Every other
encoding raises until ROADMAP A5 ports it together with the quantized
branches of the traversal and FES kernels.
"""

from __future__ import annotations

import torch

# Encodings the reference accepts for IndexConfig.pilot_dtype, widest first.
PILOT_DTYPES = ("float32", "bfloat16", "int8", "int4", "pq")
PORTED_PILOT_DTYPES = ("float32",)


def check_pilot_dtype(pilot_dtype: str) -> None:
    if pilot_dtype not in PILOT_DTYPES:
        raise ValueError(f"pilot_dtype must be one of {PILOT_DTYPES}, "
                         f"got {pilot_dtype!r}")
    if pilot_dtype not in PORTED_PILOT_DTYPES:
        raise NotImplementedError(
            f"pilot_dtype={pilot_dtype!r} is not ported yet: ROADMAP A5 "
            f"(quantized pilot payloads)")


def primary_dim(table: torch.Tensor, side=None, *, codebook=None) -> int:
    """True vector width of a stored table.  Only exact tables are ported,
    so this is the stored row width."""
    if side is not None or codebook is not None:
        raise NotImplementedError("quantized pilot tables: ROADMAP A5")
    return table.shape[-1]


def decode_rows(rows: torch.Tensor, side=None, *, codebook=None
                ) -> torch.Tensor:
    """Identity for exact tables (the only kind ported)."""
    if side is not None or codebook is not None:
        raise NotImplementedError("quantized pilot tables: ROADMAP A5")
    return rows
