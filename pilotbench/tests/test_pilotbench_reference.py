"""The frozen generator, the plain reference and the control."""

import numpy as np
import pytest
import torch

from pilotbench import check, control, reference, vectors
from pilotbench.tests.tiny import tiny_config


def test_same_seed_same_bytes():
    a = vectors.synthetic_vectors(3000, 96, n_queries=64, seed=2 ** 31 + 5,
                                  spectral_decay=0.6)
    b = vectors.synthetic_vectors(3000, 96, n_queries=64, seed=2 ** 31 + 5,
                                  spectral_decay=0.6)
    c = vectors.synthetic_vectors(3000, 96, n_queries=64, seed=2 ** 31 + 6,
                                  spectral_decay=0.6)
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()
    assert a[0].tobytes() != c[0].tobytes()
    assert a[0].dtype == np.float32 and a[1].shape == (64, 96)


@pytest.mark.parametrize("preset", ["deep", "t2i"])
def test_frozen_copy_matches_the_ports_generator_at_this_commit(preset):
    from repro_torch.data import DATASET_PRESETS, preset_dataset
    d, decay = DATASET_PRESETS[preset]
    want = preset_dataset(preset, 2500, n_queries=100, seed=11)
    got = vectors.make_dataset({"n": 2500, "d": d, "n_queries": 100,
                                "spectral_decay": decay}, 11)
    assert got[0].tobytes() == want.vectors.tobytes()
    assert got[1].tobytes() == want.queries.tobytes()


def test_exact_knn_against_numpy_brute_force():
    x, q = vectors.synthetic_vectors(3000, 48, n_queries=100, seed=3,
                                     spectral_decay=0.6)
    ids, d = reference.exact_knn(torch.from_numpy(x), torch.from_numpy(q),
                                 10, block=37)
    full = ((q.astype(np.float64)[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    wd = np.take_along_axis(full, want, 1)
    # ids agree except where the 10th and 11th distances tie in fp32
    assert (ids.numpy() == want).mean() > 0.999
    np.testing.assert_allclose(d.numpy(), wd, rtol=1e-4, atol=1e-4)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 3.14159265, -2.71828])
    r = reference.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10
    assert r[2] == 1.0                          # a tie goes to even
    assert r[3] == 1.0 + 2 ** -9                # a tie goes to even
    assert r[4] == -1.0
    bits = r.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())
    assert float(((r - x).abs() / x.abs()).max()) <= 2 ** -11


def test_control_is_not_correct_and_the_reference_is():
    """The control (the reference one precision lower than the configured
    fp32: TF32 products) fails the check; the fp32 reference passes it."""
    cfg = tiny_config()
    out = control.readings(cfg, 21, torch.device("cpu"))
    assert out["float32"]["correct"] and not out["tf32"]["correct"]
    assert out["tf32"]["dist_err"] > 3 * cfg["limits"]["dist_err"]


def test_judge_counts_each_fault_of_an_answer():
    cfg = tiny_config()
    x, q = vectors.make_dataset(cfg["data"], 5)
    xd, qd = torch.from_numpy(x), torch.from_numpy(q)
    gt, gd = reference.exact_knn(xd, qd, 10)
    ids, d = gt.numpy().copy(), gd.numpy().copy()
    qi = np.arange(len(q))
    base = check.judge(xd, qd, gt, qi, ids, d, len(q))
    assert base["bad_rows"] == 0 and base["recall_miss"] == 0
    assert base["dist_err"] < cfg["limits"]["dist_err"]
    i2 = ids.copy()
    i2[3, 4] = i2[3, 5]                                 # an id twice
    i2[7, 0] = len(x)                                   # out of range
    d2 = d.copy()
    d2[9, 2] = np.inf                                   # not finite
    d2[11, [1, 2]] = d2[11, [2, 1]] + [1.0, 0.0]        # out of order
    r = check.judge(xd, qd, gt, qi, i2, d2, len(q) + 3)
    assert r["bad_rows"] == 4 and r["missing"] == 3
    i3 = ids.copy()
    i3[:, -1] = (i3[:, -1] + 1) % len(x)                # altered answers
    assert check.judge(xd, qd, gt, qi, i3, d, len(q))["dist_err"] > 1e-3
