"""The collective ledger: bytes of every explicit cross-shard operation.

The port runs its shards under one controller (``core/distributed.py``,
``models/moe_sharded.py``), so a cross-shard operation is a Python step,
not an HLO instruction.  Each such step records here what a deployment of
one process per device would put on the wire, under the kind names XLA
gives its collectives, counted the way the reference's dry run counts HLO
(``repro.launch.dryrun.collective_bytes``): the bytes of the op's output
on one device, an all-gather at its gathered size.  Each op is recorded
once a call, not once per shard.

Recording is a counter add on the host: it reads tensor metadata only, is
off the numerics and costs no synchronisation.  A CUDA graph records at
its capture, not at its replays.
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from typing import Dict, Iterator

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_LEDGER: Counter = Counter()


def record(kind: str, nbytes: int) -> None:
    """Add ``nbytes`` (one device's output of one op) under ``kind``."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}; known: {KINDS}")
    _LEDGER[kind] += int(nbytes)
    _LEDGER["total"] += int(nbytes)


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextmanager
def counting() -> Iterator[Dict[str, int]]:
    """The ledger from zero inside the block; when the block exits, the
    yielded dict holds what it recorded (bytes by kind and ``total``, as
    ``collective_bytes`` returns them), and the ledger what it held before
    plus that."""
    saved = Counter(_LEDGER)
    _LEDGER.clear()
    out: Dict[str, int] = {}
    try:
        yield out
    finally:
        out.update(_LEDGER)
        _LEDGER.update(saved)
