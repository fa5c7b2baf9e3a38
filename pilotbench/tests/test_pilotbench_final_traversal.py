"""The reader of stage 3's kernel roofline (final_traversal_roofline) on a
trace and a window given by hand: K1's byte count with stage 3's operands
over the kernel's device time; nothing where the trace lacks a launch of
the window's counter, or the program has no such kernel (the counter
absent), and K1's own kernel is never read as stage 3's."""

from types import SimpleNamespace

import numpy as np
import pytest

from pilotbench import harness, yardstick
from pilotbench.tests.tiny import REPO
from pilotbench.trace import Trace

H100 = "NVIDIA H100 80GB HBM3"
STAGE3 = "void (anonymous namespace)::final_traversal_kernel<int, 0>(float const*)"
K1 = "void (anonymous namespace)::pilot_traversal_kernel<int, 0>(float const*)"


def _run(kernels, launches, d=96):
    stats = [{"final_dist": np.full(128, 1500, np.int32),
              "final_expanded": np.full(128, 130, np.int32)}] * 2
    return SimpleNamespace(
        device_name=H100,
        trace=Trace(window_s=1.0, device=[(k, 10.0 * i, us) for i, (k, us)
                                          in enumerate(kernels)]),
        trace_window=SimpleNamespace(batch_stats=stats, launches=launches),
        shapes={"d": d, "R": 32, "dp": d // 2, "id_bytes": 2},
        search={"ef": 128, "bloom_bits": 16384, "ef_pilot": 128, "fes_L": 32})


@pytest.mark.parametrize("d", [96, 200])
def test_reads_stage3_bytes_over_its_device_time(d):
    read = harness.load_reader(REPO, "final_traversal_roofline")
    run = _run([(STAGE3, 400.0), (STAGE3, 600.0), (K1, 500.0)],
               {"fused_final_search": 2, "fused_pilot_search": 1}, d=d)
    per_batch = yardstick.k1_bytes(
        B=128, ef=128, bloom_bits=16384, dp=d, row_bytes=4 * d, R=32,
        id_bytes=4, fresh_dists=128 * 1500, expanded=128 * 130)
    want = 100.0 * 2 * per_batch / 3.35e12 / 1000e-6
    assert read(run) == pytest.approx(want)
    assert 0 < read(run) < 100


@pytest.mark.parametrize("kernels,launches", [
    ([(STAGE3, 400.0)], {"fused_final_search": 2}),     # a launch not traced
    ([(K1, 400.0)], {"fused_pilot_search": 1}),          # no stage-3 kernel
    ([], {}),
])
def test_reads_nothing_without_every_launch(kernels, launches):
    read = harness.load_reader(REPO, "final_traversal_roofline")
    assert read(_run(kernels, launches)) is None
