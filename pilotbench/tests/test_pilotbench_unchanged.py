"""The cells over a corpus that does not change read as before the
live-set check and the held-back rows came: their datasets' bytes per seed,
and their checks' keys and values (the four standing numbers, by the
comparison over the first ``n`` rows)."""

import hashlib
import json
import time

import pytest
import torch

from pilotbench import check, harness, reference, vectors
from pilotbench.tests.tiny import BENCH, make_root

STANDING = ["missing", "bad_rows", "dist_err", "recall_miss"]
# sha256 of (vectors, queries) at n 2,000 and 256 queries, seed 2**31 + 5,
# as the generator made them before ``data.n_insert`` existed
BYTES = {"deep1m": "f86a1f22eebf9450472ff769a94eaea12e685e8db42d989359ea15d"
                   "cbe1abe7c",
         "syn200": "aeccc2d9257d7b5858140bd34973d161e9a5686956e2ac5f3afcd23"
                   "7c225dffb"}


@pytest.mark.parametrize("name", sorted(BYTES))
def test_a_configuration_without_n_insert_makes_the_same_bytes(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert "n_insert" not in cfg["data"]
    data = dict(cfg["data"], n=2000, n_queries=256)
    x, q = vectors.make_dataset(data, 2 ** 31 + 5)
    assert x.shape[0] == 2000
    assert hashlib.sha256(x.tobytes() + q.tobytes()).hexdigest() == \
        BYTES[name]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny.search", "tiny.serve"])
def test_checks_keep_their_keys_and_values(root, monkeypatch, cell):
    """The result's checks are the four standing numbers, and read what
    the comparison over the configuration's ``n`` rows reads on the same
    window."""
    seen = {}
    judge = harness.judge

    def keep(cfg, x, q, w, device):
        seen.update(cfg=cfg, x=x, q=q, w=w)
        return judge(cfg, x, q, w, device)
    monkeypatch.setattr(harness, "judge", keep)
    out = harness.run_cell(root, cell, 2 ** 31 + 61, 0.5, False,
                           torch.device("cpu"), time.perf_counter())
    assert list(out["checks"]) == STANDING
    w, x, q = seen["w"], seen["x"], seen["q"]
    assert w.mutations is None and len(x) == seen["cfg"]["data"]["n"]
    xd, qd = torch.from_numpy(x), torch.from_numpy(q)
    gt, _ = reference.exact_knn(xd, qd, 10)
    want = check.judge(xd, qd, gt, w.qidx, w.ids, w.dists, w.n_due)
    assert {k: c["value"] for k, c in out["checks"].items()} == want
    assert out["metrics"]["recall_at_10"]["value"] == \
        1.0 - want["recall_miss"]
