"""fes_tile_roofline: K3 (csrc/fes.cu, stage 0's FES distances): the least
time of each launch (yardstick.fes_bound_s: bytes or fp32 operations,
whichever bounds) over its device time in the traced window, in %.
Nothing is read unless the trace holds every launch."""

from pilotbench import yardstick


def read(run):
    tr, w = run.trace, run.trace_window
    peak = yardstick.peaks(run.device_name)
    if tr is None or w is None or not w.batch_stats or peak is None:
        return None
    us, n = tr.device_us(lambda name: yardstick.K3_KERNEL in name)
    if not us or n != w.launches.get("fes_distances", -1):
        return None
    s = run.shapes
    bound = sum(yardstick.fes_bound_s(
        r=s["fes_r"], QC=len(st["fes_dist"]), C=s["fes_C"], d=s["dp"],
        occ=len(st["fes_dist"]), row_b=s["fes_row_bytes"], side_b=0,
        peak=peak) for st in w.batch_stats)
    return 100.0 * bound / (us / 1e6)
