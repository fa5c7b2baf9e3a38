"""setup_s: seconds from the start of the process to the window: data,
kernel load (and, in a checkout's first run, their build), index build,
and the driver's warm-up (CUDA graph capture)."""


def read(run):
    return run.setup_s
