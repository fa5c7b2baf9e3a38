#!/usr/bin/env python3
"""One family's train-step loss and gradient with K8 against the plain
attention, on the card: where chip_smoke phase 10c's comparison differs.

    python3 scripts/probe_family_attention.py [--arch whisper-medium]
        [--seed 0] [--steps 1] [--seq 4096] [--batch 2]

At full width, random weights from ``--seed`` and chip_smoke 10c's AdamW
values, before any step and after ``--steps`` steps: the loss (mean of
one-sequence microbatches) with K8 everywhere, with the plain attention
everywhere, and with the plain attention in one kind of attention only
(whisper: the encoder, the decoder's self-attention, the
cross-attention), and with the plain attention rounding P to bf16 before
P·V as the reference model's attention and K8 do (``round_p``), with each
relative loss difference and the global gradient cosine against K8's.
Then K8 against its plain version (fp32 P and P rounded) at whisper's
encoder shape, ragged (S 1,500 = 11·128 + 92 keys) and aligned (S 1,536),
bf16, non-causal: the relative Frobenius error and the mean signed error
over the mean magnitude (a key of the tail tile that leaked into the
softmax would bias every row).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="whisper-medium")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_family_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import make_token_pipeline
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import layers as TL
    from repro_torch.models import steps as TS
    from repro_torch.models.frontends import synthetic_frontend_embeds
    from repro_torch.optim import AdamWConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    B, S = args.batch, args.seq
    pipe = make_token_pipeline(cfg, ShapeSpec("probe", S, B, "train"),
                               seed=args.seed)

    def batch_at(s):
        b = pipe.batch_at(s)
        if cfg.family == "encdec":
            b["frontend_embeds"] = synthetic_frontend_embeds(
                cfg, B, seed=args.seed + s, device=dev)
        return b

    k8 = TL.flash_attention

    def plain(q, k, v, *, causal=True, chunk=None):
        return flash_attention_ref(q, k, v, causal=causal)

    def round_p_ref(q, k, v, *, causal=True):
        """The plain version with P rounded to q's dtype before P·V (the
        row sum from the fp32 P), as the reference model's jnp attention
        and K8's bf16 kernel round it."""
        import math
        B_, Sq, H, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        qg = q.float().reshape(B_, Sq, Hkv, H // Hkv, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
        if causal:
            keep = (torch.arange(Sq, device=q.device)[:, None]
                    >= torch.arange(Sk, device=q.device)[None, :])
            s = s.masked_fill(~keep, -1e30)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype).float(),
                         v.float())
        l = p.sum(-1).permute(0, 3, 1, 2)[..., None]
        return (o / l.clamp_min(1e-30)).reshape(B_, Sq, H, D).to(q.dtype)

    def plain_round_p(q, k, v, *, causal=True, chunk=None):
        return round_p_ref(q, k, v, causal=causal)

    # which attention a call is: the encoder's (Sq = Sk = frames, not
    # causal), the cross-attention (Sq != Sk), or causal self-attention
    def only(kind, fn=plain):
        def attend(q, k, v, *, causal=True, chunk=None):
            enc = not causal and q.shape[1] == k.shape[1]
            cross = q.shape[1] != k.shape[1]
            this = "encoder" if enc else "cross" if cross else "self"
            return (fn if this == kind else k8)(q, k, v, causal=causal,
                                                chunk=chunk)
        return attend

    variants = {"plain": plain, "plain_round_p": plain_round_p}
    if cfg.family == "encdec":
        variants.update({f"plain_{k}": only(k)
                         for k in ("encoder", "self", "cross")})
        variants["plain_round_p_encoder"] = only("encoder", plain_round_p)
    opt = AdamWConfig(lr=4e-4, b2=0.95, weight_decay=0.1, grad_clip=1.0,
                      warmup_steps=1, total_steps=max(args.steps, 1) + 1)
    params, state = TS.init_train_state(cfg, seed=args.seed, device=dev)
    step = TS.make_train_step(cfg, opt, microbatches=1)
    out = {"arch": cfg.name, "card": torch.cuda.get_device_name(0)}
    for when in ("init", f"after {args.steps} steps"):
        if when != "init":
            for s in range(args.steps):
                step(params, state, batch_at(s))
        batch = batch_at(args.steps)
        with mock.patch.object(TL, "flash_attention", k8):
            l8, g8 = TS.accumulate_grads(params, cfg, batch, B)
        n8 = sum(float(g.double().square().sum()) for g in g8.values())
        row = {"loss_k8": float(l8)}
        for name, attend in variants.items():
            with mock.patch.object(TL, "flash_attention", attend):
                lp, gp = TS.accumulate_grads(params, cfg, batch, B)
            dot = sum(float((g8[n].double() * gp[n].double()).sum())
                      for n in g8)
            npl = sum(float(g.double().square().sum()) for g in gp.values())
            row[name] = dict(loss=float(lp),
                             loss_rel=abs(float(l8) - float(lp)) / abs(float(lp)),
                             cosine=dot / (n8 * npl) ** 0.5)
            del gp
        del g8
        out[when] = row
        print(f"[probe] {cfg.name} {when}: " + json.dumps(row), flush=True)
    del params, state
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    tail = {}
    for S_ in (1500, 1536):
        q, k, v = (torch.randn((4, S_, 16, 64), generator=g, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
        o = TL._k8(q, k, v, causal=False).float()
        for rp in (False, True):
            w = (round_p_ref if rp else flash_attention_ref)(
                q, k, v, causal=False).float()
            tail[f"S{S_}{'_round_p' * rp}"] = dict(
                rel_frobenius=float((o - w).norm() / w.norm()),
                bias=float((o - w).mean() / w.abs().mean()))
    out["k8_tail"] = tail
    print("[probe] K8 at the encoder's shape: " + json.dumps(tail), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
