"""Int8 gradient compression with error feedback.  Port of
``repro.optim.compression``.

Gradients are quantised to int8 with a per-tensor fp32 scale before a
cross-pod reduction; the quantisation error is fed back into the next
step's gradient (error feedback keeps SGD-style convergence).  The int8
payload quarters the bytes an fp32 reduction moves.  Trees are tensors or
nested mappings of them.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum_spec(g: torch.Tensor) -> int:
    """Bytes on the wire: int8 payload + one fp32 scale (vs 4B/elem fp32)."""
    return g.numel() + 4


def ef_compress_tree(grads, errors):
    """Apply error feedback then compress each leaf.  Returns (q_tree,
    scale_tree, new_error_tree), each shaped like ``grads``."""
    if isinstance(grads, torch.Tensor):
        corrected = grads.float() + errors
        q, s = compress_int8(corrected)
        return q, s, corrected - decompress_int8(q, s)
    outs = {k: ef_compress_tree(g, errors[k]) for k, g in grads.items()}
    return tuple({k: o[i] for k, o in outs.items()} for i in range(3))
