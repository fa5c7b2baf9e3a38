"""engine.rows_per_batch: requests the serving engine completed over the
batches it dispatched, both counted by the engine over the window."""


def read(run):
    e = run.window.engine
    if not e or not e.get("batches"):
        return None
    return e["completed"] / e["batches"]
