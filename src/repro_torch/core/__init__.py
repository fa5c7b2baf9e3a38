from repro_torch.core.engine import (IndexConfig, PilotANNIndex,
                                     arrays_from_numpy, brute_force_topk,
                                     recall_at_k, resolve_device)
from repro_torch.core.multistage import SearchParams

__all__ = ["IndexConfig", "PilotANNIndex", "SearchParams",
           "arrays_from_numpy", "brute_force_topk", "recall_at_k",
           "resolve_device"]
