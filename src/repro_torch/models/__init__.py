"""The dense LM of the port (the generator and embedder of the RAG path)."""

from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import (Model, decode_step, forward,
                                      init_caches, init_params, unembed,
                                      unembed_matrix)

__all__ = ["Model", "decode_step", "forward", "init_caches", "init_params",
           "params_from_reference", "unembed", "unembed_matrix"]
