"""Where the port runs: the device rule and the precision of products.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
there is no silent fallback from the card to the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for and
    there is none: callers that want the CPU say ``device="cpu"``.
    ``"meta"`` (shapes and dtypes only, no storage) is accepted by name:
    the dry run's accounting (``launch/specs.py``) builds on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be cuda, cpu or meta, got {dev}")
    return dev


@contextlib.contextmanager
def matmul_tf32(allow: bool):
    """TF32 matrix products on (``allow``) or off inside the block; the
    caller's setting is restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def fp32_products():
    """Full-fp32 matrix products inside the block (no TF32, which keeps
    about three digits and would move graph-build ties)."""
    return matmul_tf32(False)
