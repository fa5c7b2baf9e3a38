"""Top-level model: embeddings, the family's stack, the LM head, and the
caches of the serving path.  Port of ``repro.models.model``.

``init_params`` returns a ``Model`` (an ``nn.Module`` with the reference's
leaves: ``embed``, ``final_ln``, ``lm_head`` unless tied, and the family's
``layers`` (dense, moe, vlm), ``hybrid``, ``encdec`` + ``dec_pos``, or
``layers`` + ``ln_in`` (ssm)) on the card unless the caller passes
``device="cpu"``; its weights come from a ``torch.Generator`` on that
device, at the reference's scales.  The reference's numbers cannot be drawn
in torch: to run the port on the reference's weights, carry them with
``convert.params_from_reference``.  ``loss_fn`` is the training loss
(``steps.make_train_step`` differentiates it).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.devices import resolve_device
from repro_torch.core.engine import _to_tensor
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (Norm, _param, apply_norm,
                                       chunked_softmax_xent, rope_angles)

DECODER_FAMILIES = ("dense", "moe", "vlm")
DEC_POS = 65536                      # whisper's learned decoder positions


class Model(nn.Module):
    """Empty (uninitialised) weights; ``init_params`` and
    ``convert.params_from_reference`` fill them."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.embed = _param((cfg.vocab_size, cfg.d_model), torch.bfloat16, dev)
        self.final_ln = Norm(cfg.d_model, cfg.norm, device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_size),
                                  torch.bfloat16, dev)
        if cfg.family in DECODER_FAMILIES:
            self.layers = nn.ModuleList(tf.DecoderLayer(cfg, device=dev)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            self.hybrid = tf.Hybrid(cfg, device=dev)
        elif cfg.family == "encdec":
            self.encdec = tf.EncDec(cfg, device=dev)
            self.dec_pos = _param((DEC_POS, cfg.d_model), torch.bfloat16, dev)
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(tf.RwkvLayer(cfg, device=dev)
                                        for _ in range(cfg.n_layers))
            self.ln_in = Norm(cfg.d_model, cfg.norm, device=dev)
        else:
            raise ValueError(cfg.family)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def attention_calls(cfg) -> int:
    """Attention calls (K8 launches) of one full-sequence forward: one per
    decoder layer; the hybrid's shared block once per ``shared_attn_period``
    Mamba2 layers; whisper's encoder layers, and each decoder layer's self-
    and cross-attention; none in RWKV6."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_period
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def init_params(cfg, *, seed: int = 0, device=None) -> Model:
    """Random weights from ``seed``: N(0, 1)·0.02 for the embedding, the
    head and the learned positions, N(0, 1)/√d_in for every linear (drawn in
    fp32, cast to bf16, then scaled in bf16, as the reference does), each
    family's own leaves at the reference's scales, fp32 norms of ones."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(t):
        return torch.randn(t.shape, generator=g, dtype=torch.float32,
                           device=dev).to(torch.bfloat16) * 0.02

    p = Model(cfg, device=dev)
    with torch.no_grad():
        p.embed.copy_(normal(p.embed))
        if not cfg.tie_embeddings:
            p.lm_head.copy_(normal(p.lm_head))
        if cfg.family == "hybrid":
            p.hybrid.init_(g)
        elif cfg.family == "encdec":
            p.encdec.init_(g)
            p.dec_pos.copy_(normal(p.dec_pos))
        else:
            for lp in p.layers:
                lp.init_(g)
    return p


def _embed(p: Model, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding: its backward on the card sums each row's gradients in a
    # fixed order (a replayed step is bit-equal)
    return F.embedding(tokens, p.embed)


def _angles_for(cfg, positions, B: int, S: int, device=None):
    """RoPE angles of ``positions`` ((B, S), or (3, B, S) for M-RoPE; None:
    0 .. S - 1 on every stream), None for learned or no positions."""
    if cfg.pos_type in ("learned", "none"):
        return None
    if positions is None:
        positions = torch.arange(S, device=device).expand(B, S)
        if cfg.pos_type == "mrope":
            positions = positions.expand(3, B, S)
    else:
        positions = torch.as_tensor(positions, device=device)
    secs = cfg.mrope_sections if cfg.pos_type == "mrope" else None
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta, secs)


def _merge_frontend(cfg, h: torch.Tensor, frontend_embeds):
    """Early fusion: the first n_frontend_tokens embeddings replaced by the
    (stub) modality embeddings."""
    if frontend_embeds is None or cfg.frontend == "none" \
            or cfg.family == "encdec":
        return h
    n = cfg.n_frontend_tokens
    return torch.cat([frontend_embeds.to(h.dtype), h[:, n:]], dim=1)


def _tokens(p: Model, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=p.device).long()


def _embeds(p: Model, x) -> Optional[torch.Tensor]:
    """Frontend embeddings (torch, or host arrays; bf16 host arrays cross
    as their bit patterns) on the model's device."""
    return None if x is None else _to_tensor(x).to(p.device)


def forward(params: Model, cfg, tokens, *, frontend_embeds=None,
            positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (hidden (B, S, d), aux loss).  ``tokens``
    (B, S) ints (numpy or torch); ``frontend_embeds`` (B, n_frontend_tokens,
    d): a VLM's early-fused patches, whisper's encoder frames (required
    there); ``positions``: (B, S), or (3, B, S) for M-RoPE."""
    tokens = _tokens(params, tokens)
    B, S = tokens.shape
    fe = _embeds(params, frontend_embeds)
    h = _merge_frontend(cfg, _embed(params, tokens), fe)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    angles = _angles_for(cfg, positions, B, S, device=h.device)
    if cfg.family in DECODER_FAMILIES:
        h, aux = tf.decoder_stack(params.layers, h, cfg, angles)
    elif cfg.family == "hybrid":
        h = tf.hybrid_forward(params.hybrid, h, cfg, angles)
    elif cfg.family == "encdec":
        if fe is None:
            raise ValueError(f"{cfg.name}: the encoder-decoder forward needs "
                             f"frontend_embeds (B, {cfg.n_frontend_tokens}, "
                             f"{cfg.d_model}), the encoder's frames")
        memory = tf.encoder_forward(params.encdec, fe, cfg)
        h = tf.encdec_decoder(params.encdec,
                              h + params.dec_pos[:S][None].to(h.dtype), cfg,
                              memory)
    else:
        h = apply_norm(params.ln_in, h, cfg.norm)
        h = tf.rwkv_stack(params.layers, h, cfg)
    return apply_norm(params.final_ln, h, cfg.norm), aux


def unembed_matrix(params: Model, cfg) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def unembed(params: Model, cfg, h: torch.Tensor) -> torch.Tensor:
    return (h @ unembed_matrix(params, cfg)).float()


def init_caches(params: Model, cfg, batch: int, seq: int,
                frontend_embeds=None) -> dict:
    """The family's decode state, zero: KV caches (L, B, S, Hkv, hd); the
    hybrid's Mamba2 states and one KV cache per shared-block invocation;
    RWKV6's shift and WKV states; whisper's self caches and each decoder
    layer's cross K/V ``xk``/``xv`` of the encoder memory of
    ``frontend_embeds`` (zeros when not given, as in the reference)."""
    dev = params.device
    if cfg.family in DECODER_FAMILIES:
        return tf.init_kv_caches(cfg, batch, seq, device=dev)
    if cfg.family == "hybrid":
        return tf.init_hybrid_caches(cfg, batch, seq, device=dev)
    if cfg.family == "ssm":
        return tf.init_rwkv_caches(cfg, batch, device=dev)
    kv = tf.init_kv_caches(cfg, batch, seq, device=dev)
    fe = _embeds(params, frontend_embeds)
    if fe is None:
        fe = torch.zeros((batch, cfg.n_frontend_tokens, cfg.d_model),
                         dtype=torch.bfloat16, device=dev)
    memory = tf.encoder_forward(params.encdec, fe, cfg)
    xk, xv = tf.cross_kv(params.encdec, memory, cfg)
    return {**kv, "xk": xk, "xv": xv}


def decode_step(params: Model, cfg, token, caches: dict, pos: int
                ) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  token: (B, 1) ints; pos: the current write
    position (number of tokens already in context).  Returns (logits
    (B, 1, V) fp32, caches), the caches written in place."""
    token = _tokens(params, token)
    B = token.shape[0]
    pos = int(pos)
    h = _embed(params, token)
    positions = torch.full((B, 1), pos, device=h.device)
    if cfg.pos_type == "mrope":
        positions = positions.expand(3, B, 1)
    angles = _angles_for(cfg, positions, B, 1, device=h.device)
    if cfg.family in DECODER_FAMILIES:
        h, caches = tf.decoder_stack_decode(params.layers, h, cfg, angles,
                                            caches, pos)
    elif cfg.family == "hybrid":
        h, caches = tf.hybrid_decode(params.hybrid, h, cfg, angles, caches,
                                     pos)
    elif cfg.family == "encdec":
        h = h + params.dec_pos[pos:pos + 1][None].to(h.dtype)
        h, caches = tf.encdec_decode(params.encdec, h, cfg, caches, pos)
    else:
        h = apply_norm(params.ln_in, h, cfg.norm)
        h, caches = tf.rwkv_stack_decode(params.layers, h, cfg, caches)
    h = apply_norm(params.final_ln, h, cfg.norm)
    return unembed(params, cfg, h), caches


def loss_fn(params: Model, cfg, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(nll + aux, {"nll", "aux"}) of ``batch`` (``tokens``, ``labels``,
    optional ``loss_mask``, ``frontend_embeds`` and ``positions``; numpy or
    torch)."""
    h, aux = forward(params, cfg, batch["tokens"],
                     frontend_embeds=batch.get("frontend_embeds"),
                     positions=batch.get("positions"))
    labels = torch.as_tensor(batch["labels"], device=h.device)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=h.device)
    nll = chunked_softmax_xent(h, unembed_matrix(params, cfg), labels,
                               mask=mask)
    return nll + aux, {"nll": nll, "aux": aux}
