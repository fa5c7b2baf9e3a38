"""engine.in_flight_ms: the mean milliseconds a request of the measured window
spends from the dispatch of its batch to the start of that batch's drain:
the pilot stage and the wait behind the batches ahead, on the serving
engine's one clock: the program's counters ``engine.in_flight_us`` over
``engine.requests``. Nothing is read where no request completed through the
engine's drain."""


def read(run):
    w = run.window
    n = w.launches.get("engine.requests")
    if not n:
        return None
    return w.launches["engine.in_flight_us"] / n / 1e3
