"""The dense LM of the port: the generator and embedder of the RAG path,
and the model of the training path."""

from repro_torch.models.convert import (opt_state_from_reference,
                                        params_from_reference)
from repro_torch.models.model import (Model, decode_step, forward,
                                      init_caches, init_params, loss_fn,
                                      unembed, unembed_matrix)

__all__ = ["Model", "decode_step", "forward", "init_caches", "init_params",
           "loss_fn", "opt_state_from_reference", "params_from_reference",
           "unembed", "unembed_matrix"]
