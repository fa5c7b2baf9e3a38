"""Batched bloom-filter visited tables (PilotANN §4.3), in PyTorch.

One filter per in-flight query.  Two multiply-shift hashes into ``n_bits``
buckets; false positives only make the search *skip* a node (never
recompute), and the multi-stage pipeline corrects any quality impact
downstream, exactly as in the paper.  No false negatives.

The public layout is the reference's: a ``(B, n_bits)`` bool tensor.  The
CUDA traversal kernels pack it 32x into shared-memory words for the
duration of a launch (``csrc/traversal.cu``), a layout detail.

Hashes are bit-identical to ``repro.core.bloom.hashes``.  PyTorch has no
usable uint32 shift/modulo on the CPU, so the uint32 arithmetic runs in
int64 with ``& 0xFFFFFFFF`` after every multiply (the low 32 bits of an
int64 product are the uint32 product, wrap-around included).

Inserts are an OR: a bit hit by two ids, one masked in and one masked out,
ends up set.  ``scatter_reduce_(..., reduce="amax")`` on a uint8 view gives
that deterministically (plain advanced-index assignment of the mask would
let the last write win).
"""

from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
# multiply-shift hash constants (odd, well-mixed) — same as the reference
_H1 = 0x9E3779B1
_H2 = 0x85EBCA77
_H3 = 0xC2B2AE3D
_H4 = 0x27D4EB2F


def hashes(ids: torch.Tensor, n_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    x = ids.to(torch.int64) & _M32
    h1 = ((x * _H1) & _M32) ^ (((x * _H2) & _M32) >> 15)
    h2 = ((x * _H3) & _M32) ^ (x >> 13) ^ ((x * _H4) & _M32)
    return (h1 % n_bits).to(torch.int64), (h2 % n_bits).to(torch.int64)


def _or_insert(filt: torch.Tensor, idx: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """``filt[b, idx[b, j]] |= mask[b, j]`` for every (b, j), in place on a
    copy (the reference's functional ``.at[...].max``)."""
    out = filt.clone()
    out.view(torch.uint8).scatter_reduce_(1, idx, mask.to(torch.uint8),
                                          reduce="amax")
    return out


def bloom_init(batch: int, n_bits: int, device=None) -> torch.Tensor:
    return torch.zeros((batch, n_bits), dtype=torch.bool, device=device)


def bloom_test(filt: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """filt: (B, n_bits); ids: (B, R) -> (B, R) bool (maybe-visited)."""
    h1, h2 = hashes(ids, filt.shape[-1])
    return torch.gather(filt, 1, h1) & torch.gather(filt, 1, h2)


def bloom_insert(filt: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Insert ids where mask; returns the updated filters."""
    h1, h2 = hashes(ids, filt.shape[-1])
    return _or_insert(filt, torch.cat([h1, h2], dim=1),
                      torch.cat([mask, mask], dim=1))


# ---------------------------------------------------------------------------
# Exact visited bitmap (no false positives — for tests / small corpora)
# ---------------------------------------------------------------------------

def exact_init(batch: int, n: int, device=None) -> torch.Tensor:
    return torch.zeros((batch, n + 1), dtype=torch.bool,
                       device=device)  # +1: sentinel id slot


def exact_test(filt: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return torch.gather(filt, 1, ids.to(torch.int64))


def exact_insert(filt: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    return _or_insert(filt, ids.to(torch.int64), mask)
