from repro_torch.core.engine import (IndexConfig, PilotANNIndex,
                                     ResidencyPlan, ResidencyPlanner,
                                     arrays_from_numpy, brute_force_topk,
                                     recall_at_k, resolve_device)
from repro_torch.core.multistage import SearchParams
from repro_torch.core.pipeline import (degrade_params, pipelined_search,
                                       split_stages)
from repro_torch.core.segments import (DeltaSegment, SegmentedIndex,
                                       UpdateParams, merge_topk)
from repro_torch.core.distributed import (PodIndexSpec, ShardParams,
                                          ShardedSegmentedIndex)

__all__ = ["DeltaSegment", "IndexConfig", "PilotANNIndex", "PodIndexSpec",
           "ResidencyPlan", "ResidencyPlanner", "SearchParams",
           "SegmentedIndex", "ShardParams", "ShardedSegmentedIndex",
           "UpdateParams", "arrays_from_numpy", "brute_force_topk",
           "degrade_params", "merge_topk", "pipelined_search", "recall_at_k",
           "resolve_device", "split_stages"]
