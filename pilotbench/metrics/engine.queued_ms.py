"""engine.queued_ms: the mean milliseconds a request of the measured window
spends from its enqueue to the dispatch of its batch: the wait for a batch
to form, on the serving engine's one clock: the program's counters
``engine.queued_us`` over ``engine.requests``. Nothing is read where no
request completed through the engine's drain."""


def read(run):
    w = run.window
    n = w.launches.get("engine.requests")
    if not n:
        return None
    return w.launches["engine.queued_us"] / n / 1e3
