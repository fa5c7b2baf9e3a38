"""final_traversal_roofline: stage 3's kernel (csrc/traversal.cu
``final_traversal_kernel``, the persistent final traversal over the full
graph and vectors): the least time the bytes its inputs need take at the
card's memory rate, over its device time in the traced window, in %.
The bytes are K1's count (yardstick.k1_bytes) with stage 3's operands: the
full fp32 rows (4·d bytes), the full graph's int32 rows, the search's ef
and filter, and the batch's own ``final_dist`` and ``final_expanded``
(stage 3's start scores nothing itself: its one entry is the sentinel).
Nothing is read unless the trace holds every launch of the window's
``fused_final_search`` counter, so a program without that kernel reads
nothing."""

from pilotbench import yardstick

KERNEL = "final_traversal"


def read(run):
    tr, w = run.trace, run.trace_window
    peak = yardstick.peaks(run.device_name)
    if tr is None or w is None or not w.batch_stats or peak is None:
        return None
    us, n = tr.device_us(lambda name: KERNEL in name)
    if not us or n != w.launches.get("fused_final_search", -1):
        return None
    s, p = run.shapes, run.search
    total = 0.0
    for st in w.batch_stats:
        total += yardstick.k1_bytes(
            B=len(st["final_dist"]), ef=p["ef"], bloom_bits=p["bloom_bits"],
            dp=s["d"], row_bytes=4 * s["d"], R=s["R"], id_bytes=4,
            fresh_dists=int(st["final_dist"].astype("int64").sum()),
            expanded=int(st["final_expanded"].astype("int64").sum()))
    return 100.0 * total / peak["hbm_bytes_per_s"] / (us / 1e6)
