"""The control of the correctness check, at a cell's own size, on the chip.

    python3 pilotbench/control.py --config deep1m --seeds 11 12 13

For each seed it makes the configuration's vectors (the first ``n``: the
corpus the index is built over, before any held-back row is inserted) and
query pool, puts the plain reference in the program's place one precision
lower than the configuration states (``reference.exact_knn(precision=
"tf32")``: products of TF32-rounded operands), answers every pool query
with it, and judges
those answers with the benchmark's own comparison (``check.judge``) against
the fp32 reference.  The control has to come out not correct: its
``dist_err`` is the upper reading that the configuration's limit is set
below.  The fp32 reference is judged the same way beside it.  One JSON
line per seed and precision.  The benchmark's runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def readings(cfg: dict, seed: int, device) -> dict:
    """``{precision: the four numbers and correct}`` of the reference put
    in the program's place, for one seed: the control (``tf32``) and the
    reference at the configured precision (``float32``)."""
    import numpy as np
    import torch
    from pilotbench import check, reference, vectors
    x, q = vectors.make_dataset(cfg["data"], seed)
    x = x[:int(cfg["data"]["n"])]
    xd, qd = torch.from_numpy(x).to(device), torch.from_numpy(q).to(device)
    k = int(cfg["search"].get("k", 10))
    gt, _ = reference.exact_knn(xd, qd, k)
    out = {}
    for prec in ("tf32", "float32"):
        ids, dists = reference.exact_knn(xd, qd, k, precision=prec)
        r = check.judge(xd, qd, gt, np.arange(len(q)), ids.cpu().numpy(),
                        dists.cpu().numpy(), len(q))
        # the numbers of a changing corpus have no reading here: no row
        # changes under the control (their faults: pilotbench/tests)
        c = check.verdict(r, {k: v for k, v in cfg["limits"].items()
                              if k in r})
        out[prec] = dict(r, correct=check.is_correct(c))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch
    from pilotbench import harness, manifest
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    man = manifest.load(ROOT)
    cfg = json.loads((ROOT / manifest.config_entry(
        man, args.config)["file"]).read_text())
    dev = torch.device("cuda", 0)
    print(f"# {harness.power_limit()}", flush=True)
    for seed in args.seeds:
        t = time.perf_counter()
        for prec, r in readings(cfg, seed, dev).items():
            print(json.dumps({"config": args.config, "seed": seed,
                              "precision": prec, **r,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
