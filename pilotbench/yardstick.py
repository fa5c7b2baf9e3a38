"""The yardstick's arithmetic: the card's peaks, and the least bytes a
kernel needs for the inputs it was given (its roofline bound).

Peaks are NVIDIA's published numbers for the H100 SXM at its full 700 W
limit; a card set lower runs slower under load, so the power limit is
printed beside every run.  The byte counts are those the port's chip proof
used for K1 (the persistent pilot traversal) and K3 (the stage-0 FES
distances), frozen here so that a change to the program cannot move them.
"""

from __future__ import annotations

from typing import Optional

# name fragment of torch.cuda.get_device_name() -> peaks
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12,
             "tf32_flops_per_s": 495e12, "bf16_flops_per_s": 989e12},
}

# substrings of the names of the port's own CUDA kernels (csrc/*.cu), as a
# trace shows them; every other kernel is a library (torch) kernel
K1_KERNEL = "pilot_traversal"           # K1 (persistent) and K2 (per hop)
K3_KERNEL = "fes_tile"                  # K3/K4 (dense and int4 entries)
NAMED_KERNELS = (K1_KERNEL, K3_KERNEL, "fes_pq", "expand_merge",
                 "candidate_merge", "flash")


def peaks(device_name: str) -> Optional[dict]:
    for frag, p in PEAKS.items():
        if frag in device_name:
            return p
    return None


def k1_bytes(*, B: int, ef: int, bloom_bits: int, dp: int, row_bytes: int,
             R: int, id_bytes: int, fresh_dists: int, expanded: int) -> float:
    """Bytes one persistent pilot traversal (K1) of a batch needs: each
    freshly scored pilot row (``row_bytes``) and each expanded node's
    neighbour row (``R`` ids of ``id_bytes``) read once, the (B, dp) fp32
    queries read once, the (B, ef) beam of ids, distances and flags and the
    (B, bloom_bits) byte filter read and written once each, and three (B,)
    int32 counters written.  ``fresh_dists`` and ``expanded`` are the
    batch's totals of the kernel's own counters."""
    beam = B * ef * (4 + 4 + 1)
    filt = B * bloom_bits
    return (fresh_dists * row_bytes + expanded * R * id_bytes + B * dp * 4
            + 2 * beam + 2 * filt + B * 12)


def fes_bound_s(*, r: int, QC: int, C: int, d: int, occ: int, row_b: int,
                side_b: int, peak: dict) -> float:
    """Seconds one FES distance launch (K3) needs at least: q (r, QC, d)
    fp32 and the (r, C) entry rows of ``row_b`` bytes plus ``side_b`` side
    bytes read once, the (r, QC, C) fp32 output written once; operations
    (2·d per occupied slot and entry, 2·d per entry for its norm) over the
    fp32 peak.  The larger of the two."""
    nbytes = 4.0 * r * QC * d + r * C * row_b + side_b + 4.0 * r * QC * C
    ops = 2.0 * occ * C * d + 2.0 * r * C * d
    return max(ops / peak["fp32_flops_per_s"],
               nbytes / peak["hbm_bytes_per_s"])
