"""stage2.device_ms_per_batch: device milliseconds a batch of stage 2
(refine_stage's torch ops), in the measured window: the program's counter
``stage2.device_ns``, which the timing events its CUDA graphs record at
each stage marker feed (``repro_torch/runtime/trace.py``), over the
window's batches. The measured window runs without the profiler, whose per-
kernel tracing stretches the gaps between a graph's nodes. Nothing is read
where the counter did not move (no CUDA graphs, or a program without the
counter), nor where the window dropped a timing
(``trace.readings_dropped``: a graph run again before its timing was read),
since the counter then holds less than the device ran."""


def read(run):
    w = run.window
    ns = w.launches.get("stage2.device_ns")
    if not ns or not w.batches or w.launches.get("trace.readings_dropped"):
        return None
    return ns / 1e6 / w.batches
