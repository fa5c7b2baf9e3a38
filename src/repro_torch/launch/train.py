"""Fault-tolerant training driver.  Port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 20 --reduced --device cpu [--ckpt-dir DIR]

Without ``--device`` it trains on the card.  The flow is the reference's:
restore-or-init through ``CheckpointManager`` (resuming after the
checkpointed step, ``RestartPolicy.replay_from``), ``pipeline.batch_at(step)``
per step (data is a pure function of (seed, step), so a replayed step sees
the same batch), a log line every ``log_every`` steps, ``maybe_save`` after
each step and a forced save at the end.  The reference's mesh and sharding
(``launch.mesh``, ``launch.sharding``) are left out: one card has nothing to
shard.  ``jax.jit(donate_argnums)`` has no counterpart: the step updates the
model and the optimizer state in place.

A checkpoint holds ``(params, opt_state)``: ``{name: tensor}`` of the
model's parameters and the AdamW state ``{"m", "v", "step"}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, ShapeSpec, get_config, reduced
from repro_torch.core.devices import resolve_device
from repro_torch.data import make_token_pipeline
from repro_torch.models import steps as ST
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import RestartPolicy


def train_tree(params, opt_state):
    """What a checkpoint holds: ``({name: parameter}, opt_state)``."""
    return dict(params.named_parameters()), opt_state


def _restore(params, opt_state, tree) -> None:
    """Copy a loaded ``train_tree`` into the model and the state in place."""
    loaded_p, loaded_o = tree
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(loaded_p[n])
    for key in ("m", "v"):
        for n, t in opt_state[key].items():
            t.copy_(loaded_o[key][n])
    opt_state["step"].copy_(loaded_o["step"])


def train(arch: str, *, steps: int = 100, use_reduced: bool = False,
          ckpt_dir: Optional[str] = None, save_interval: int = 50,
          seed: int = 0, shape: Optional[ShapeSpec] = None,
          log_every: int = 10, opt_cfg: Optional[AdamWConfig] = None,
          device=None, n_layers: Optional[int] = None):
    """Train ``arch`` for ``steps`` steps (from a checkpoint in
    ``ckpt_dir`` when there is one) -> (model, [(step, loss), ...]).
    ``n_layers`` cuts the depth and keeps every width."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
        shape = shape or ShapeSpec("smoke", 64, 8, "train")
    else:
        shape = shape or SHAPES["train_4k"]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)

    pipeline = make_token_pipeline(cfg, shape, seed=seed)
    train_step = ST.make_train_step(cfg, opt_cfg)
    params, opt_state = ST.init_train_state(cfg, seed=seed, device=dev)

    manager = CheckpointManager(ckpt_dir, save_interval=save_interval) \
        if ckpt_dir else None
    restart = RestartPolicy()

    start_step = 0
    if manager is not None:
        restored = manager.restore_or_none(train_tree(params, opt_state),
                                           device=dev)
        if restored is not None:
            tree, ckpt_step = restored
            _restore(params, opt_state, tree)
            del tree
            start_step = restart.replay_from(ckpt_step)
            print(f"[train] restored step {ckpt_step}, resuming at "
                  f"{start_step}")

    history = []
    t0 = time.time()
    for step in range(start_step, steps):
        params, opt_state, metrics = train_step(params, opt_state,
                                                pipeline.batch_at(step))
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            history.append((step, loss))
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (step - start_step + 1):.2f}s/step)")
        if manager is not None:
            manager.maybe_save(step, train_tree(params, opt_state),
                               meta={"arch": cfg.name})
    if manager is not None:
        manager.maybe_save(steps - 1, train_tree(params, opt_state),
                           force=True, meta={"arch": cfg.name})
    return params, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-interval", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, use_reduced=args.reduced,
          ckpt_dir=args.ckpt_dir, save_interval=args.save_interval,
          seed=args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
