"""stage3.rounds_per_batch: the expansion rounds of stage 3 (the final
traversal) that a batch needs, its slowest query's ``final_hops``, as the
search's stats count them; the mean over the window's batches."""

import numpy as np


def read(run):
    st = run.window.batch_stats
    if not st or "final_hops" not in st[0]:
        return None
    return float(np.mean([int(s["final_hops"].max()) for s in st]))
