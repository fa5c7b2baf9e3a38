"""The plain reference: exact k-nearest-neighbour search under squared L2,
in plain PyTorch, and the fp64 distance of any (query, id) pair.

It imports nothing of the program and takes nothing the program made: it
reads the vectors and queries the benchmark generated.  ``exact_knn``
multiplies in fp32 with TF32 off (``precision="float32"``).  The control of
the correctness check is the same search one precision lower
(``precision="tf32"``): both operands of the product rounded to TF32's 10
mantissa bits, as the tensor cores round them, and the products summed in
fp32.  Emulating the rounding keeps the control the same on every device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

PRECISIONS = ("float32", "tf32")


@contextlib.contextmanager
def tf32_off():
    """fp32 products in fp32 on the card (the process's flags restored)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to the nearest TF32 value (10 mantissa bits,
    ties to even), kept in fp32."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def exact_knn(x: torch.Tensor, q: torch.Tensor, k: int, *,
              precision: str = "float32", block: int = 1024,
              live: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest rows of ``x`` (n, d) to each row of ``q`` (Q, d) by
    ``|q|^2 + |x|^2 - 2 q.x``: (ids (Q, k) int64, squared distances (Q, k)
    fp32), nearest first.  Queries go in blocks of ``block`` rows.  With
    ``live`` (n,) bool, only the live rows count: the others lie at
    ``+inf``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    x = x.float()
    xn = (x * x).sum(1)
    if live is not None:
        xn = xn.masked_fill(~live, float("inf"))
    xm = round_tf32(x) if precision == "tf32" else x
    ids, dists = [], []
    with tf32_off():
        for s in range(0, q.shape[0], block):
            qb = q[s:s + block].float()
            qm = round_tf32(qb) if precision == "tf32" else qb
            d = (qb * qb).sum(1)[:, None] + xn[None, :] - 2.0 * (qm @ xm.T)
            dv, iv = torch.topk(d, k, dim=1, largest=False, sorted=True)
            ids.append(iv)
            dists.append(dv)
    return torch.cat(ids), torch.cat(dists)


def pair_dists64(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``q`` (A, d) and its ids (A, k), valid rows of ``x``:
    the squared distance summed in fp64 from the differences, and the scale
    ``|q|^2 + |x|^2`` in fp64 that an fp32 distance's rounding grows
    with."""
    xv = x[ids].double()                              # (A, k, d)
    qd = q.double()[:, None, :]
    d64 = ((xv - qd) ** 2).sum(-1)
    scale = (xv * xv).sum(-1) + (qd * qd).sum(-1)
    return d64, scale
