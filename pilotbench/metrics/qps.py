"""qps: queries answered in the window over the window's seconds, from its
start to the last answer (closed loops only: in an open loop the answered
rate is the offered one)."""


def read(run):
    w = run.window
    if w.open_loop or not w.seconds:
        return None
    return len(w.qidx) / w.seconds
