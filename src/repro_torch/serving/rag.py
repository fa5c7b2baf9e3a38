"""Retrieval-augmented serving: embed -> PilotANN search -> augmented
decode.  Port of ``repro.serving.rag``.

This is the paper's deployment context (RAG / retrieval engines): the
vector search engine is the first-class serving feature, and the LM stack
supplies both the query embeddings and the generator.  ``embed`` runs the
full-sequence forward, whose every layer's attention is the flash-attention
kernel K8 on the card; ``retrieve`` runs ``PilotANNIndex.search`` (K3 and
K1); ``generate`` decodes greedily over KV caches.  The model and the index
must live on one device.  The model runs under ``torch.inference_mode()``
(the search does not: its captured graphs keep their buffers), so a model
whose parameters require gradients serves as one whose do not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import PilotANNIndex
from repro_torch.core.multistage import SearchParams
from repro_torch.models import Model
from repro_torch.models import decode_step as model_decode
from repro_torch.models import forward as model_forward
from repro_torch.models import init_caches


@dataclass
class RagPipeline:
    index: PilotANNIndex
    params: Model
    cfg: object
    search_params: Optional[SearchParams] = None
    max_new_tokens: int = 8

    def __post_init__(self):
        if self.search_params is None:
            self.search_params = SearchParams(k=4, ef=64, ef_pilot=64)
        model_dev = self.params.device
        index_dev = self.index.arrays["rot_vecs"].device
        if model_dev != index_dev:
            raise ValueError(f"the model is on {model_dev} and the index on "
                             f"{index_dev}: a RagPipeline runs on one device")

    # -- embedding: mean-pooled final hidden state of the LM --------------
    def embed(self, tokens: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            h, _ = model_forward(self.params, self.cfg, tokens)
            emb = h.float().mean(1)
            emb = emb / torch.linalg.vector_norm(
                emb, dim=-1, keepdim=True).clamp_min(1e-6)
            return emb.cpu().numpy()

    def embed_to_corpus_dim(self, tokens: np.ndarray) -> np.ndarray:
        emb = self.embed(tokens)
        d = self.index.d
        if emb.shape[1] >= d:
            return np.ascontiguousarray(emb[:, :d])
        reps = -(-d // emb.shape[1])
        return np.ascontiguousarray(np.tile(emb, (1, reps))[:, :d])

    # -- retrieve ---------------------------------------------------------
    def retrieve(self, query_tokens: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        q = self.embed_to_corpus_dim(query_tokens)
        ids, dists, _ = self.index.search(q, self.search_params)
        return ids, dists

    # -- generate with retrieved context ----------------------------------
    def generate(self, query_tokens: np.ndarray,
                 context_tokens_for: Callable[[int], np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy decode conditioned on the top retrieved passage, the
        context cut to the query's length.  Returns (new_tokens (B,
        max_new), retrieved ids (B, k))."""
        ids, _ = self.retrieve(query_tokens)
        B = query_tokens.shape[0]
        ctx = np.stack([
            np.concatenate([context_tokens_for(int(ids[b, 0])),
                            query_tokens[b]])[-query_tokens.shape[1]:]
            for b in range(B)])
        with torch.inference_mode():
            seq = ctx.shape[1] + self.max_new_tokens
            caches = init_caches(self.params, self.cfg, B, seq)
            dev = self.params.device
            ctx_t = torch.as_tensor(ctx, device=dev).long()
            # prefill by stepping, as the reference does
            out = torch.zeros((B, self.max_new_tokens), dtype=torch.int32,
                              device=dev)
            tok = ctx_t[:, :1]
            pos = 0
            for t in range(1, ctx.shape[1]):
                _, caches = model_decode(self.params, self.cfg, tok, caches,
                                         pos)
                tok = ctx_t[:, t:t + 1]
                pos += 1
            for t in range(self.max_new_tokens):
                logits, caches = model_decode(self.params, self.cfg, tok,
                                              caches, pos)
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                out[:, t] = tok[:, 0].to(torch.int32)
                pos += 1
            return out.cpu().numpy(), ids
