"""Find the highest rate the serving engine sustains, once, on the chip.

    python3 pilotbench/sweep.py --config deep1m --traffic serve.poisson \\
        --rates 2400 2800 3200 3600 --seconds 8 --seed 7
    python3 pilotbench/sweep.py --config deep1m-mutable \\
        --traffic serve.mutable --share 0.5 --rates 5000 9000 13000 --seconds 6

Builds the configuration's index and the mix's engine once, then offers
each rate in turn for ``--seconds`` (open loop, Poisson arrivals, timed
from each request's due time) and prints one JSON line per rate: the rate
completed, latency percentiles, the requests still waiting when the
arrivals stopped, and p95 over the last third of the arrivals against the
first third.  A rate is sustained when at most two batches of requests
are still waiting at the end and the last third's p95 is at most 1.25x the
first third's; the last line names the highest sustained rate and
``--share`` of it, the rate a cell below capacity offers.  The benchmark's
cells take a fixed rate from this; this script is not run by them.  A mix
that changes the corpus changes it through the whole sweep, so its
held-back rows have to last.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def step(driver, rate: float, seconds: float) -> dict:
    import numpy as np
    from pilotbench.drivers import max_gap_s
    driver.rate = rate
    w = driver.run(seconds)
    lat = 1e3 * (w.done_t - w.due_t)
    third = seconds / 3
    first, last = lat[w.due_t < third], lat[w.due_t >= 2 * third]
    waiting = int(np.sum(w.done_t > seconds)) + (w.n_due - len(w.qidx))
    rows = w.engine["completed"] / max(w.engine["batches"], 1)
    p95 = lambda a: float(np.percentile(a, 95)) if len(a) else float("nan")
    out = {"offered": rate, "due": w.n_due,
           "completed_per_s": float(np.sum(w.done_t <= seconds) / seconds),
           "p50_ms": float(np.percentile(lat, 50)), "p95_ms": p95(lat),
           "p99_ms": float(np.percentile(lat, 99)),
           "p95_first_third_ms": p95(first), "p95_last_third_ms": p95(last),
           "waiting_at_end": waiting, "rows_per_batch": rows,
           "max_gap_ms": 1e3 * max_gap_s(w.done_t, seconds)}
    if "mutation_time_s" in w.engine:      # a mix that changes the corpus
        out["mutation_pct"] = 100.0 * w.engine["mutation_time_s"] / seconds
        out["delta_captures"] = w.engine["delta_captures"]
    out["sustained"] = bool(waiting <= 2 * max(rows, 1.0)
                            and out["p95_last_third_ms"]
                            <= 1.25 * out["p95_first_third_ms"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="deep1m")
    ap.add_argument("--traffic", default="serve.poisson")
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--share", type=float, default=0.8)
    args = ap.parse_args()
    import torch
    from pilotbench import drivers, harness, manifest, system, vectors
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    man = manifest.load(ROOT)
    cfg = json.loads((ROOT / manifest.config_entry(
        man, args.config)["file"]).read_text())
    traffic = json.loads(manifest.traffic_file(ROOT,
                                               args.traffic).read_text())
    dev = torch.device("cuda", 0)
    print(f"# {harness.power_limit()}", flush=True)
    x, q = vectors.make_dataset(cfg["data"], args.seed)
    system.build_kernels()
    n = int(cfg["data"]["n"])
    index = system.build_index(cfg, x[:n], dev)
    sut = harness.SUT(index=index, params=system.search_params(cfg),
                      held=x[n:] if len(x) > n else None,
                      device=dev)
    driver = drivers.make(ROOT, sut, q, traffic, args.seed)
    driver.setup()
    print(f"# set-up {time.perf_counter() - T_START:.1f} s", flush=True)
    best = None
    for rate in args.rates:
        row = step(driver, rate, args.seconds)
        print(json.dumps(row), flush=True)
        if row["sustained"]:
            best = rate
    print(json.dumps({"highest_sustained": best,
                      f"cell_rate_{args.share:g}x":
                      None if best is None else args.share * best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
