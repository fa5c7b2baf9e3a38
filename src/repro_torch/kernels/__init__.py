"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Nothing here builds or imports CUDA code at import time: the wrappers build
``csrc/`` at their first call on a CUDA tensor (``_build.py``)."""

from repro_torch.kernels.build_kernel import fused_candidate_merge
from repro_torch.kernels.fes_kernel import (fes_distances,
                                            fes_int4_distances,
                                            fes_pq_distances)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import fes_select
from repro_torch.kernels.topk_kernel import fused_expand_merge
from repro_torch.kernels.traversal_kernel import (fused_pilot_search,
                                                  fused_traversal_hop)

KERNELS = (fused_pilot_search, fused_traversal_hop, fes_distances,
           fes_int4_distances, fes_pq_distances, fused_expand_merge,
           fused_candidate_merge, flash_attention)


def launch_counts() -> dict:
    """Launches of each wrapper's kernel; ``flash_attention`` counts both
    of K8's kernels and ``flash_attention_bf16`` the tensor-core one."""
    counts = {k.__name__: k.launches for k in KERNELS}
    counts["flash_attention_bf16"] = flash_attention.bf16_launches
    return counts


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    flash_attention.bf16_launches = 0


def add_launch_counts(delta: dict) -> None:
    """Add ``{name: n}`` (names as in ``launch_counts``) to the counters: a
    replayed CUDA graph counts the launches it holds this way."""
    for name, n in delta.items():
        if name == "flash_attention_bf16":
            flash_attention.bf16_launches += n
        else:
            fn = next(k for k in KERNELS if k.__name__ == name)
            fn.launches += n


__all__ = ["KERNELS", "fes_distances", "fes_int4_distances",
           "fes_pq_distances", "fes_select", "flash_attention",
           "fused_candidate_merge", "fused_expand_merge", "fused_pilot_search", "fused_traversal_hop",
           "add_launch_counts", "launch_counts", "reset_launch_counts"]
