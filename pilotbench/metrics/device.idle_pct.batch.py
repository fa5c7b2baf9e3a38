"""device.idle_pct.batch: the share of the measured window of batch search
in which the device ran no operation, in %: the device's busy seconds a
batch, from the traced window, times the batches a second of the untraced
window (``trace.idle_pct``)."""

from pilotbench.trace import idle_pct


def read(run):
    return idle_pct(run.trace, run.trace_window, run.window)
