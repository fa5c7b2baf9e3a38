"""peak_mem_gib: the device memory allocated at the peak of the window
(the allocator's peak reset after set-up), in GiB."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2 ** 30
