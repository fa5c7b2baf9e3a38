"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Nothing here builds or imports CUDA code at import time: the wrappers build
``csrc/`` at their first call on a CUDA tensor (``_build.py``).

Each wrapper counts its kernel's launches in the program's counter registry
(``runtime/trace.py``), under the wrapper's name; ``launch_counts`` returns
the whole registry, which holds the search's, the stages' and the serving
engine's counters beside the launches."""

from repro_torch.kernels.build_kernel import fused_candidate_merge
from repro_torch.kernels.fes_kernel import (fes_distances,
                                            fes_int4_distances,
                                            fes_pq_distances)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import fes_select
from repro_torch.kernels.topk_kernel import fused_expand_merge
from repro_torch.kernels.traversal_kernel import (fused_final_search,
                                                  fused_pilot_search,
                                                  fused_traversal_hop)
from repro_torch.runtime import trace

KERNELS = (fused_pilot_search, fused_traversal_hop, fused_final_search,
           fes_distances,
           fes_int4_distances, fes_pq_distances, fused_expand_merge,
           fused_candidate_merge, flash_attention)

# the registry's launch counters, a name each: ``flash_attention`` counts
# both of K8's kernels and ``flash_attention_bf16`` the tensor-core one
LAUNCH_NAMES = tuple(k.__name__ for k in KERNELS) + ("flash_attention_bf16",)
trace.declare(LAUNCH_NAMES)


def launch_counts() -> dict:
    """The counter registry (``runtime/trace.counts``): launches by wrapper
    name, and every other counter of the program under its dotted name
    (``search.host_tests``, ``stage3.device_ns``, ``engine.queued_us``, …),
    with the graph timings that have completed folded in."""
    return trace.counts()


def reset_launch_counts() -> None:
    """Zero every counter of the registry."""
    trace.reset()


def add_launch_counts(delta: dict) -> None:
    """Add ``{name: n}`` (names as in ``launch_counts``) to the counters: a
    replayed CUDA graph counts the launches it holds this way."""
    trace.add(delta)


__all__ = ["KERNELS", "LAUNCH_NAMES", "fes_distances", "fes_int4_distances",
           "fes_pq_distances", "fes_select", "flash_attention",
           "fused_candidate_merge", "fused_expand_merge", "fused_final_search",
           "fused_pilot_search", "fused_traversal_hop",
           "add_launch_counts", "launch_counts", "reset_launch_counts"]
