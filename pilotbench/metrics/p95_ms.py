"""p95_ms: the 95th percentile of request latency over every request due
in the window, from the moment it was due to the moment the benchmark saw
it completed (open loops only)."""

import numpy as np


def read(run):
    w = run.window
    if not w.open_loop or not len(w.done_t):
        return None
    return float(np.percentile(1e3 * (w.done_t - w.due_t), 95))
