"""Shape-and-dtype stand-ins for every input of every (architecture x
shape) cell — port of ``repro.launch.specs``.

The reference returns ``jax.ShapeDtypeStruct``s from ``jax.eval_shape``;
the port returns ``meta`` tensors (shapes and dtypes, no storage) built by
its own constructors: ``Model`` for the parameters, ``adamw_init`` for the
optimizer state, ``model.init_caches`` for the decode caches.  Nothing is
allocated and nothing is computed, except whisper's cross K/V, whose
constructor runs the encoder, here on ``meta`` with the attention as a
shape-only stand-in.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict
from unittest import mock

import torch

from repro_torch.configs import ModelConfig, ShapeSpec
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.optim import adamw_init

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@contextmanager
def meta_attention(on_call=None):
    """``layers``' attention kernel replaced, inside the block, by a
    stand-in that returns a ``meta`` tensor of the output's shape (the
    CUDA kernel takes no meta tensors); ``on_call(q, k, v, causal)`` is
    called on each use, for the dry run's accounting."""
    def k8(q, k, v, *, causal=True):
        if on_call is not None:
            on_call(q, k, v, causal)
        return torch.empty_like(q)

    with mock.patch.object(layers, "_k8", k8):
        yield


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Inputs for train/prefill (the data batch)."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {"tokens": sds((B, S), torch.int32)}
    if shape.mode == "train":
        out["labels"] = sds((B, S), torch.int32)
    if cfg.frontend != "none":
        out["frontend_embeds"] = sds((B, cfg.n_frontend_tokens, cfg.d_model),
                                     torch.bfloat16)
    if cfg.pos_type == "mrope":
        out["positions"] = sds((3, B, S), torch.int32)
    return out


def params_specs(cfg: ModelConfig) -> M.Model:
    """The port's ``Model`` on ``meta``: its parameters are the stand-ins."""
    return M.Model(cfg, device=META)


def opt_specs(cfg: ModelConfig, params) -> dict:
    return adamw_init(params)


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, params) -> dict:
    """KV/SSM cache stand-ins for decode cells (cache length = seq_len)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend != "none":
        fe = sds((B, cfg.n_frontend_tokens, cfg.d_model), torch.bfloat16)
        with meta_attention(), torch.inference_mode():
            return M.init_caches(params, cfg, B, S, frontend_embeds=fe)
    return M.init_caches(params, cfg, B, S)


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B = shape.global_batch
    return {"token": sds((B, 1), torch.int32), "pos": sds((), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Every input of the cell's step function but the params, optimizer
    state and caches, which have their own helpers."""
    if shape.mode in ("train", "prefill"):
        return batch_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
