#!/usr/bin/env python3
"""olmoe-1b-7b at full width on the card: where the full-sequence forward
and teacher-forced decode part.

    python3 scripts/probe_moe_routing.py [--seed 0] [--batch 4] [--seq 256]

Runs chip_smoke phase 10b's comparison (random weights from ``--seed``,
B x S tokens) with bf16 weights and again with the same weights in fp32
(TF32 off), and for each MoE layer reports: the tokens whose top-k expert
set differs between the prefill and the decode, the (token, expert) pairs
the prefill's capacity dropped, and the prefill router's gap between the
k-th and the (k+1)-th probability (its median, and the share under 1e-3).
Prints one JSON line per dtype.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced() config, with --device cpu a "
                         "rehearsal of the script on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_moe_routing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import _build
    from repro_torch.models import (decode_step, forward, init_caches,
                                    init_params, unembed)
    from repro_torch.models import moe as TMo
    from repro_torch.models import transformer as TF

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    if dev.type == "cuda":
        _build.build_all()
    cfg = get_config(args.arch)
    cfg = reduced(cfg) if args.reduced else cfg
    B, S, k, E = args.batch, args.seq, cfg.top_k, cfg.n_experts
    tok = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    calls = []
    real = TMo.moe_ffn

    def recording(p, x, c):
        T = x.shape[0] * x.shape[1]
        logits = x.reshape(T, -1).float() @ p.router
        probs = torch.softmax(logits, -1)
        top = probs.topk(k + 1, dim=-1).values
        C = TMo._capacity(T, k, E, c.capacity_factor)
        *_, token_slots, _, _, _ = TMo.route(logits, k, C)
        calls.append(dict(top_e=probs.topk(k, dim=-1).indices.sort(-1).values,
                          gap=(top[:, k - 1] - top[:, k]),
                          dropped=int((token_slots == E * C).sum())))
        return real(p, x, c)

    params = init_params(cfg, seed=args.seed, device=dev)
    out = {}
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            params.float()
        calls.clear()
        with torch.inference_mode():
            TF.moe_ffn = recording
            try:
                h, _ = forward(params, cfg, tok)
                full = unembed(params, cfg, h)
                pre = list(calls)
                calls.clear()
                caches = init_caches(params, cfg, B, S + 1)
                step = torch.empty_like(full)
                for t in range(S):
                    lg, caches = decode_step(params, cfg, tok[:, t:t + 1],
                                             caches, t)
                    step[:, t] = lg[:, 0]
                dec = list(calls)
            finally:
                TF.moe_ffn = real
        L = cfg.n_layers
        layers = []
        for i in range(L):
            pe = pre[i]["top_e"].reshape(B, S, k)
            de = torch.stack([dec[t * L + i]["top_e"] for t in range(S)], 1)
            differ = (pe != de).any(-1)
            gap = pre[i]["gap"]
            layers.append(dict(layer=i, tokens_routed_otherwise=int(
                differ.sum()), dropped_at_prefill=pre[i]["dropped"],
                gap_median=float(gap.median()),
                gap_share_below_1e_3=float((gap < 1e-3).float().mean())))
        flips = full.argmax(-1) != step.argmax(-1)
        out[dtype] = dict(
            top1=1.0 - float(flips.float().mean()),
            rel=float((full - step).abs().mean() / full.abs().mean()),
            tokens=B * S, layers=layers)
        print(f"[probe] {cfg.name} {dtype}: " + json.dumps(out[dtype]),
              flush=True)
        del full, step, caches, h
    card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": card, **{
        d: {k_: v for k_, v in o.items() if k_ != "layers"}
        for d, o in out.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
