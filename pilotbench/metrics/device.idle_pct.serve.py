"""device.idle_pct.serve: the share of the measured window of serving in
which the device ran no operation, in %: the device's busy seconds an
engine batch, from the traced window, times the engine's batches a second
of the untraced window (``trace.idle_pct``)."""

from pilotbench.trace import idle_pct


def read(run):
    return idle_pct(run.trace, run.trace_window, run.window)
