"""engine.mutation_pct: the share of the measured window that the serving
engine spent applying mutations (insert repair, tombstones, the delta's
refresh), in %: the engine's own ``mutation_time_s`` over the window,
over the window's seconds.  Nothing is read where the window drove no
mutation."""


def read(run):
    w = run.window
    t = w.engine.get("mutation_time_s")
    if not t or not w.seconds:
        return None
    return 100.0 * t / w.seconds
