"""search.host_tests_per_batch: the host tests of convergence a batch
makes in the measured window (one before each chunk of 8 rounds of each
loop, core/compiled.py): the program's counter ``search.host_tests`` over
the window's batches.  Nothing is read where the counter did not move."""


def read(run):
    w = run.window
    n = w.launches.get("search.host_tests")
    if not n or not w.batches:
        return None
    return n / w.batches
