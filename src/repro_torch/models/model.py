"""Top-level model: embeddings, the dense decoder stack, the LM head, and
the KV caches of the serving path.  Port of ``repro.models.model`` for the
families whose stack is the uniform decoder (dense; moe and vlm raise in
the layers they add).

``init_params`` returns a ``Model`` (an ``nn.Module`` with the reference's
leaves: ``embed``, ``final_ln``, ``lm_head`` unless tied, ``layers``) on
the card unless the caller passes ``device="cpu"``; its weights come from a
``torch.Generator`` on that device, at the reference's scales.  The
reference's numbers cannot be drawn in torch: to run the port on the
reference's weights, carry them with ``convert.params_from_reference``.
``loss_fn`` is the training loss (``steps.make_train_step`` differentiates
it).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.devices import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (Norm, apply_norm, chunked_softmax_xent,
                                       rope_angles)
from repro_torch.models.transformer import NOT_PORTED

DENSE_FAMILIES = ("dense", "moe", "vlm")


class Model(nn.Module):
    """Empty (uninitialised) weights unless ``layers`` are given;
    ``init_params`` and ``convert.params_from_reference`` fill them."""

    def __init__(self, cfg, *, device=None,
                 layers: Optional[nn.ModuleList] = None):
        super().__init__()
        if cfg.family not in DENSE_FAMILIES:
            raise NotImplementedError(f"the {cfg.family} family {NOT_PORTED}")
        dev = resolve_device(device)
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.d_model), dtype=torch.bfloat16, device=dev),
            requires_grad=False)
        self.final_ln = Norm(cfg.d_model, cfg.norm, device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                (cfg.d_model, cfg.vocab_size), dtype=torch.bfloat16,
                device=dev), requires_grad=False)
        self.layers = layers if layers is not None else nn.ModuleList(
            tf.DecoderLayer(cfg, device=dev) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg, *, seed: int = 0, device=None) -> Model:
    """Random weights from ``seed``: N(0, 1)·0.02 for the embedding and the
    head, N(0, 1)/√d_in for every linear (drawn in fp32, cast to bf16, then
    scaled in bf16, as the reference does), fp32 norms of ones."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=g, dtype=torch.float32,
                           device=dev).to(torch.bfloat16)

    embed = normal((cfg.vocab_size, cfg.d_model)) * 0.02
    head = (None if cfg.tie_embeddings
            else normal((cfg.d_model, cfg.vocab_size)) * 0.02)
    p = Model(cfg, device=dev,
              layers=tf.init_decoder_stack(cfg, g, device=dev))
    p.embed.copy_(embed)
    if head is not None:
        p.lm_head.copy_(head)
    return p


def _embed(p: Model, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding: its backward on the card sums each row's gradients in a
    # fixed order (a replayed step is bit-equal)
    return F.embedding(tokens, p.embed)


def _angles_for(cfg, positions: Optional[torch.Tensor], B: int, S: int,
                device=None):
    if cfg.pos_type in ("learned", "none"):
        return None
    if positions is None:
        positions = torch.arange(S, device=device).expand(B, S)
    secs = cfg.mrope_sections if cfg.pos_type == "mrope" else None
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta, secs)


def _tokens(p: Model, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=p.device).long()


def forward(params: Model, cfg, tokens, *,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (hidden (B, S, d), aux loss).  ``tokens``
    (B, S) ints (numpy or torch).  The reference's ``frontend_embeds``
    (vlm/encdec) are not taken."""
    tokens = _tokens(params, tokens)
    B, S = tokens.shape
    h = _embed(params, tokens)
    angles = _angles_for(cfg, positions, B, S, device=h.device)
    h, aux = tf.decoder_stack(params.layers, h, cfg, angles)
    return apply_norm(params.final_ln, h, cfg.norm), aux


def unembed_matrix(params: Model, cfg) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def unembed(params: Model, cfg, h: torch.Tensor) -> torch.Tensor:
    return (h @ unembed_matrix(params, cfg)).float()


def init_caches(params: Model, cfg, batch: int, seq: int) -> dict:
    return tf.init_kv_caches(cfg, batch, seq, device=params.device)


def decode_step(params: Model, cfg, token, caches: dict, pos: int
                ) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  token: (B, 1) ints; pos: the current write
    position (number of tokens already in context).  Returns (logits
    (B, 1, V) fp32, caches), the caches written in place."""
    token = _tokens(params, token)
    B = token.shape[0]
    pos = int(pos)
    h = _embed(params, token)
    angles = _angles_for(cfg, torch.full((B, 1), pos, device=h.device),
                         B, 1)
    h, caches = tf.decoder_stack_decode(params.layers, h, cfg, angles,
                                        caches, pos)
    h = apply_norm(params.final_ln, h, cfg.norm)
    return unembed(params, cfg, h), caches


def loss_fn(params: Model, cfg, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(nll + aux, {"nll", "aux"}) of ``batch`` (``tokens``, ``labels``,
    optional ``loss_mask`` and ``positions``; numpy or torch)."""
    h, aux = forward(params, cfg, batch["tokens"],
                     positions=batch.get("positions"))
    labels = torch.as_tensor(batch["labels"], device=h.device)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=h.device)
    nll = chunked_softmax_xent(h, unembed_matrix(params, cfg), labels,
                               mask=mask)
    return nll + aux, {"nll": nll, "aux": aux}
