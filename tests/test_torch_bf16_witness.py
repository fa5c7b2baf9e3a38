"""The bf16 prefill/decode agreement of the zamba2 hybrid and RWKV6 at
width: the port's against the reference's own, on the same weights.

The reference's bars for teacher-forced decode against the full-sequence
forward (``tests/test_models.py``: top-1 >= 0.95, mean relative logit error
< 0.15) are met at ``reduced()`` size.  At width and full depth the two
bf16 paths of the reference itself drift apart on logit near-ties: at
d_model 256–1,024 and full depth its top-1 agreement reads 0.83–0.94.
The card's full-width runs (``chip_smoke.py`` phase 10b) hold the port's
bf16 agreement of these two families at a bar below 0.95 on that account;
this file is its witness.  The test holds, at a quarter of full width and
full depth, that the port's mean relative logit error between its prefill
and its decode is no larger than the reference's (with a quarter of room
for rounding), and reports both top-1 agreements.  Run as a script it
prints the same numbers at any width:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_bf16_witness.py \\
        --d-model 512 --batch 4 --seq 128
"""

import argparse
import dataclasses
import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.models import model as TM
from repro_torch.models import params_from_reference

torch.set_num_threads(1)

ARCHS = ("zamba2-1.2b", "rwkv6-1.6b")
# the port's prefill/decode logit error against the reference's: at most
# this factor (measured 0.45-0.98 at d_model 256-1,024, full depth)
REL_FACTOR = 1.25


def witness_config(cfgs, arch: str, d_model: int, vocab: int):
    """``arch`` at ``d_model`` and full depth, with its full-width head,
    state and period sizes (head dim 64, SSM state 64, shared block every 6
    layers, RWKV LoRA 64) and d_ff scaled with the width."""
    full = cfgs.get_config(arch)
    cfg = cfgs.reduced(full, layers=full.n_layers, d_model=d_model,
                       vocab=vocab)
    heads = d_model // full.head_dim
    return dataclasses.replace(
        cfg, n_heads=heads, n_kv_heads=heads, head_dim=full.head_dim,
        d_ff=full.d_ff * d_model // full.d_model, ssm_state=full.ssm_state,
        ssm_head_dim=full.ssm_head_dim,
        shared_attn_period=full.shared_attn_period,
        rwkv_head_dim=full.rwkv_head_dim, rwkv_lora_dim=full.rwkv_lora_dim)


def _agreement(full: np.ndarray, step: np.ndarray) -> dict:
    flips = full.argmax(-1) != step.argmax(-1)
    return dict(top1=float(1.0 - flips.mean()),
                rel=float(np.abs(full - step).mean() / np.abs(full).mean()))


def witness(arch: str, d_model: int, vocab: int, B: int, S: int,
            seed: int = 0) -> dict:
    """The reference's and the port's bf16 prefill against teacher-forced
    decode on the same weights (the reference's, carried over) and
    tokens."""
    jcfg = witness_config(JC, arch, d_model, vocab)
    tcfg = witness_config(TC, arch, d_model, vocab)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(seed),
                                                    jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tok = np.random.default_rng(seed + 1).integers(
        1, vocab, (B, S)).astype(np.int32)

    h, _ = jax.jit(JM.forward, static_argnums=1)(jp, jcfg, jnp.asarray(tok))
    ref_full = np.asarray(JM.unembed(jp, jcfg, h).astype(jnp.float32))
    decode = jax.jit(JM.decode_step, static_argnums=1)
    caches = jax.jit(JM.init_caches, static_argnums=(1, 2, 3))(
        jp, jcfg, B, S + 1)
    steps = []
    for t in range(S):
        lg, caches = decode(jp, jcfg, jnp.asarray(tok[:, t:t + 1]), caches,
                            jnp.int32(t))
        steps.append(np.asarray(lg.astype(jnp.float32))[:, 0])
    ref_step = np.stack(steps, 1)

    with torch.inference_mode():
        h, _ = TM.forward(tp, tcfg, tok)
        port_full = TM.unembed(tp, tcfg, h).float().numpy()
        caches = TM.init_caches(tp, tcfg, B, S + 1)
        steps = []
        for t in range(S):
            lg, caches = TM.decode_step(tp, tcfg, tok[:, t:t + 1], caches, t)
            steps.append(lg.float().numpy()[:, 0])
    port_step = np.stack(steps, 1)
    return dict(arch=arch, d_model=d_model, n_layers=tcfg.n_layers,
                vocab=vocab, tokens=[B, S], seed=seed,
                reference=_agreement(ref_full, ref_step),
                port=_agreement(port_full, port_step),
                port_vs_reference_prefill=_agreement(ref_full, port_full))


def hold_witness(arch: str) -> None:
    """The test of one arch at a quarter of full width (d_model 256) and
    full depth, 2 x 64 tokens; ``test_torch_bf16_witness_hybrid.py`` runs
    the zamba2 hybrid's (a file of its own: each takes ~40-50 s)."""
    w = witness(arch, d_model=256, vocab=8192, B=2, S=64)
    print(json.dumps(w))
    assert np.isfinite(w["port"]["rel"]) and np.isfinite(w["reference"]["rel"])
    assert w["port"]["rel"] <= REL_FACTOR * w["reference"]["rel"], w


def test_bf16_prefill_decode_drift_is_the_references_rwkv6():
    hold_witness("rwkv6-1.6b")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=0,
                    help="0: the arch's own vocabulary")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for arch in args.archs:
        vocab = args.vocab or TC.get_config(arch).vocab_size
        print(json.dumps(witness(arch, args.d_model, vocab, args.batch,
                                 args.seq, args.seed)), flush=True)


if __name__ == "__main__":
    main()
