"""Atomic, keep-last-N checkpoints of nested trees of tensors.  Port of
``repro.checkpoint.store``, in its on-disk format:

    <dir>/step_<k:08d>/
        MANIFEST.json  — step, time, meta, and per leaf its file, shape, dtype
        <leaf-id>.npy  — one file per leaf (the full array)
    <dir>/LATEST       — atomic pointer (write tmp + rename)

A tree is a tensor, a numpy array or scalar, or a mapping (keys in sorted
order, as a JAX pytree flattens a dict), tuple or list of trees.  A leaf's
id is its path of keys and indices joined by ``/``; its file name the id
with ``/`` → ``__``.  bf16 is stored as its uint16 bit pattern under dtype
``"bfloat16"`` (no ``ml_dtypes``: the bits cross as 16-bit integers).  A
checkpoint is staged under ``.tmp_step_<k>``, every file fsync'd, and
renamed into place; a crash mid-save never corrupts the restore point.

``load_checkpoint(..., device=)`` puts each leaf on ``device``, the one-card
counterpart of the reference's ``shardings=``; without it the leaves are
CPU tensors.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

BF16 = "bfloat16"


def _children(tree):
    """(key, subtree) pairs of a node; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), t) for i, t in enumerate(tree)]
    return None


def _leaf_files(tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix or "root": tree}
    leaves = {}
    for k, sub in kids:
        leaves.update(_leaf_files(sub, f"{prefix}/{k}" if prefix else k))
    return leaves


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return BF16
    return str(arr.dtype)


def _fsync_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(directory: str, step: int, tree, *,
                    meta: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "time": time.time(), "meta": meta or {},
                "leaves": {}}
    for key, leaf in _leaf_files(tree).items():
        arr = _to_numpy(leaf)
        dtype_name = _dtype_name(leaf, arr)
        if dtype_name == BF16:
            arr = arr.view(np.uint16)
        fname = key.replace("/", "__") + ".npy"
        _fsync_write(os.path.join(tmp, fname), lambda f: np.save(f, arr))
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype_name}
    _fsync_write(os.path.join(tmp, "MANIFEST.json"),
                 lambda f: f.write(json.dumps(manifest).encode()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _write_latest(directory, step)
    return final


def _write_latest(directory: str, step: int) -> None:
    tmp = os.path.join(directory, ".LATEST.tmp")
    _fsync_write(tmp, lambda f: f.write(str(step).encode()))
    os.rename(tmp, os.path.join(directory, "LATEST"))


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _rebuild(tree_like, load, prefix: str = ""):
    kids = _children(tree_like)
    if kids is None:
        return load(prefix or "root")
    out = [(k, _rebuild(sub, load, f"{prefix}/{k}" if prefix else k))
           for k, sub in kids]
    if isinstance(tree_like, dict):
        by_name = dict(out)
        return {k: by_name[str(k)] for k in tree_like}
    return type(tree_like)(v for _, v in out)


def load_checkpoint(directory: str, tree_like, *, step: Optional[int] = None,
                    device=None):
    """Restore a tree shaped like ``tree_like`` -> (tree, step).  Every
    leaf becomes a tensor (bf16 leaves ``torch.bfloat16``) on ``device``,
    the CPU when it is None."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)

    def load(key):
        info = manifest["leaves"][key]
        arr = np.load(os.path.join(d, info["file"]))
        if info["dtype"] == BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t if device is None else t.to(device)

    return _rebuild(tree_like, load), step


class CheckpointManager:
    """Keep-last-N manager with restart discovery."""

    def __init__(self, directory: str, *, keep: int = 3,
                 save_interval: int = 100):
        self.directory = directory
        self.keep = keep
        self.save_interval = save_interval

    def maybe_save(self, step: int, tree, *, meta=None, force=False
                   ) -> Optional[str]:
        if not force and (step % self.save_interval != 0 or step == 0):
            return None
        path = save_checkpoint(self.directory, step, tree, meta=meta)
        self._gc()
        return path

    def restore_or_none(self, tree_like, *, device=None):
        if latest_step(self.directory) is None:
            return None
        return load_checkpoint(self.directory, tree_like, device=device)

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
