"""pilot_traversal_roofline: K1 (csrc/traversal.cu, the persistent pilot
traversal of stage 1): the least time the bytes its inputs need take at
the card's memory rate, over its device time in the traced window, in %.
The bytes come from the batch's own counters (yardstick.k1_bytes); the
entries scored before the kernel starts (at most fes_L a query) are left
out.  Nothing is read unless the trace holds every launch."""

import numpy as np

from pilotbench import yardstick


def read(run):
    tr, w = run.trace, run.trace_window
    peak = yardstick.peaks(run.device_name)
    if tr is None or w is None or not w.batch_stats or peak is None:
        return None
    us, n = tr.device_us(lambda name: yardstick.K1_KERNEL in name)
    if not us or n != w.launches.get("fused_pilot_search", -1):
        return None
    s, p = run.shapes, run.search
    total = 0.0
    for st in w.batch_stats:
        fresh = np.maximum(st["pilot_dist"].astype(np.int64) - p["fes_L"], 0)
        total += yardstick.k1_bytes(
            B=len(st["pilot_dist"]), ef=p["ef_pilot"],
            bloom_bits=p["bloom_bits"], dp=s["dp"],
            row_bytes=s["pilot_row_bytes"], R=s["R"], id_bytes=s["id_bytes"],
            fresh_dists=int(fresh.sum()),
            expanded=int(st["pilot_expanded"].sum()))
    return 100.0 * total / peak["hbm_bytes_per_s"] / (us / 1e6)
