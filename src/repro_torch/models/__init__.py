"""The LMs of the port, every arch id's family (dense, MoE, VLM, the zamba2
hybrid, whisper's encoder-decoder, RWKV6): the generator and embedder of
the RAG path, and the model of the training path."""

from repro_torch.models.convert import (opt_state_from_reference,
                                        params_from_reference)
from repro_torch.models.model import (Model, attention_calls, decode_step,
                                      forward, init_caches, init_params,
                                      loss_fn, unembed, unembed_matrix)

__all__ = ["Model", "attention_calls", "decode_step", "forward",
           "init_caches", "init_params", "loss_fn",
           "opt_state_from_reference", "params_from_reference", "unembed",
           "unembed_matrix"]
