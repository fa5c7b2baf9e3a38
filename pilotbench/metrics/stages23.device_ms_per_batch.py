"""stages23.device_ms_per_batch: device milliseconds per batch of every
kernel that is not one of the port's own CUDA kernels (stages 2 and 3 are
torch ops; stage 0's routing and stage 1's start are a few more of them),
from the traced window."""

from pilotbench import yardstick


def _library(name: str) -> bool:
    return (not name.startswith(("Memcpy", "Memset"))
            and not any(k in name for k in yardstick.NAMED_KERNELS))


def read(run):
    tr, w = run.trace, run.trace_window
    if tr is None or w is None or not w.batch_stats:
        return None
    us, n = tr.device_us(_library)
    if not n:
        return None
    return us / 1e3 / len(w.batch_stats)
