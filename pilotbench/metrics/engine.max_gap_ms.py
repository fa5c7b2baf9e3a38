"""engine.max_gap_ms: the longest stretch of the window in which no
request completed, on the benchmark's clock (a stall shows here; open
loops only)."""

from pilotbench.drivers import max_gap_s


def read(run):
    w = run.window
    if not w.open_loop:
        return None
    return 1e3 * max_gap_s(w.done_t, w.seconds)
