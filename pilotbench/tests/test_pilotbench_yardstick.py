"""The K1/K3 byte arithmetic and the trace reading."""

from types import SimpleNamespace

import pytest

from pilotbench import yardstick
from pilotbench.trace import Trace, idle_pct

H100 = yardstick.peaks("NVIDIA H100 80GB HBM3")


def test_peaks_by_card_name():
    assert H100["hbm_bytes_per_s"] == 3.35e12
    assert yardstick.peaks("NVIDIA A100-SXM4-80GB") is None


def test_k1_bytes_by_hand():
    # 2 queries, ef 4, a 64-bit filter, dp 8 fp32 rows, R 3 int32 ids,
    # 10 fresh distances and 5 expansions
    got = yardstick.k1_bytes(B=2, ef=4, bloom_bits=64, dp=8, row_bytes=32,
                             R=3, id_bytes=4, fresh_dists=10, expanded=5)
    want = 10 * 32 + 5 * 3 * 4 + 2 * 8 * 4 + 2 * (2 * 4 * 9) + 2 * (2 * 64) \
        + 2 * 12
    assert got == want


def test_k1_bytes_at_the_deep1m_batch():
    # PR 24's main-path batch: B 128, ef 128, 16,384-bit filter, dp 48
    got = yardstick.k1_bytes(B=128, ef=128, bloom_bits=16384, dp=48,
                             row_bytes=192, R=32, id_bytes=4,
                             fresh_dists=128 * 1195, expanded=128 * 130)
    # PERF.md's K1 row: bound 0.01045 ms
    assert got / H100["hbm_bytes_per_s"] * 1e3 == pytest.approx(0.01045,
                                                                 rel=0.03)


def test_fes_bound_bytes_and_operations():
    # deep1m's stage 0: r 32, QC 128, C 512, d 48, 128 occupied slots
    s = yardstick.fes_bound_s(r=32, QC=128, C=512, d=48, occ=128,
                              row_b=192, side_b=0, peak=H100)
    nbytes = 4 * 32 * 128 * 48 + 32 * 512 * 192 + 4 * 32 * 128 * 512
    assert s == pytest.approx(nbytes / 3.35e12)
    assert s * 1e3 == pytest.approx(0.00368, rel=0.01)   # PERF.md's K3 row
    # every slot occupied, wide rows of one byte a dim: the operations bound
    s2 = yardstick.fes_bound_s(r=1, QC=1024, C=1024, d=1024, occ=1024,
                               row_b=1024, side_b=0, peak=H100)
    assert s2 == pytest.approx((2 * 1024 ** 3 + 2 * 1024 ** 2) / 67e12)


def test_trace_busy_union_and_gaps():
    dev = [("k_a", 30.0, 5.0), ("k_b", 32.0, 6.0), ("Memcpy DtoH", 60.0, 10.0)]
    host = [("pilotbench.search", 0.0, 100.0), ("cudaStreamSynchronize",
                                                  40.0, 15.0)]
    tr = Trace(window_s=100e-6, device=dev, host=host, t0=0.0)
    assert tr.busy_s == pytest.approx(18e-6)            # 30-38 and 60-70
    gaps = tr.idle_gaps()
    # 0-30 and 70-100 under the span alone, 38-60 under the sync
    assert gaps["pilotbench.search"] == pytest.approx(60e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(22e-6)
    assert sum(gaps.values()) == pytest.approx(100e-6 - tr.busy_s)
    us, n = tr.device_us(lambda name: name.startswith("k_"))
    assert (us, n) == (11.0, 2)
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "Memcpy DtoH"
    assert len(b["idle_gaps"]) <= 10


def test_idle_share_takes_busy_from_the_trace_and_rate_from_the_window():
    tr = Trace(window_s=100e-6, device=[("k", 0.0, 18.0)], t0=0.0)
    traced = SimpleNamespace(batches=2)               # 9 us busy a batch
    untraced = SimpleNamespace(batches=10, seconds=100e-6)
    assert idle_pct(tr, traced, untraced) == pytest.approx(10.0)
    assert idle_pct(None, traced, untraced) is None
    assert idle_pct(Trace(window_s=1.0, device=[]), traced, untraced) is None
    assert idle_pct(tr, SimpleNamespace(batches=0), untraced) is None
