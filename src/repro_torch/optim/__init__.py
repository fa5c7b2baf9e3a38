"""The optimizer and gradient compression of the training path."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           compressed_psum_spec)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_int8", "decompress_int8", "compressed_psum_spec"]
