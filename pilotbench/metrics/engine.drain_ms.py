"""engine.drain_ms: the mean milliseconds a request of the measured window
spends from the start of its batch's drain to its completion: the CPU
stages and the readback, on the serving engine's one clock: the program's
counters ``engine.drain_us`` over ``engine.requests``. Nothing is read
where no request completed through the engine's drain."""


def read(run):
    w = run.window
    n = w.launches.get("engine.requests")
    if not n:
        return None
    return w.launches["engine.drain_us"] / n / 1e3
