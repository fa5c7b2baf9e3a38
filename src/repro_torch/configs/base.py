"""Config system: model configs, input-shape specs, and the arch registry —
a copy of ``repro.configs.base`` (plain data, no JAX), so that the port
imports nothing of the JAX package.

Every assigned architecture is a ``ModelConfig`` in its own module under
``repro_torch.configs``; the registry maps an arch id to it.  ``reduced()``
produces a tiny same-family config for CPU smoke tests.  The port runs the
dense family (``models/``); ``param_count()`` is the analytic count.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2) / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_period: int = 0  # zamba2: shared attn+mlp block every N layers

    # --- RWKV6 ---
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64

    # --- positional / frontend ---
    rope_theta: float = 1e4
    pos_type: str = "rope"  # rope | mrope | learned | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    frontend: str = "none"  # none | audio | vision
    n_frontend_tokens: int = 0  # whisper encoder frames / vision patches

    # --- enc-dec ---
    n_encoder_layers: int = 0

    # --- misc ---
    act: str = "silu"  # silu (gated) | gelu (non-gated)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    qk_norm: bool = False
    dtype: str = "bfloat16"

    # --- distribution hints ---
    fsdp: bool = False  # 2D weight sharding (model x data) for very large models
    fsdp_inference: bool = False  # keep 2D weight sharding in prefill/decode
                                  # (weight-gathered inference, >100B models)
    subquadratic: bool = False  # supports long_500k decode
    remat: bool = True
    attn_chunk: int = 1024  # flash-attention query/kv chunk
    lower_unroll: bool = False  # dry-run accounting: unroll every scan so
                                # cost_analysis() sees true per-step costs
    microbatches: int = 1  # train-step gradient-accumulation factor

    source: str = ""  # provenance tag from the assignment table

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoder-bearing

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.family == "ssm":  # rwkv6
            # time-mix: r,k,v,w,g projections + output, channel-mix 2 mats
            tm = 5 * d * d + d * d
            cm = d * ff + ff * d
            total += L * (tm + cm)
            return total
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        mlp_gated = 3 * d * ff if self.act == "silu" else 2 * d * ff
        if self.family == "hybrid":  # zamba2: mamba backbone + ONE shared attn block
            d_in = self.ssm_expand * d
            mamba = (d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim)
                     + d_in * d)
            total += L * mamba
            n_shared = max(1, L // max(1, self.shared_attn_period))
            total += attn + mlp_gated  # one shared parameter set
            total += n_shared * (2 * d) * d  # per-invocation input projectors
            return total
        if self.is_moe:
            expert = 3 * d * ff
            per_layer = attn + self.n_experts * expert + d * self.n_experts
            per_layer += self.n_shared_experts * 3 * d * (ff * 2)
            total += L * per_layer
            return total
        total += L * (attn + mlp_gated)
        if self.n_encoder_layers:
            enc_attn = 2 * (d * nh * hd) + 2 * (d * nkv * hd)
            total += self.n_encoder_layers * (attn + mlp_gated)
            total += L * (attn // 2 + enc_attn // 2)  # decoder cross-attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        expert = 3 * d * ff
        total = self.param_count()
        total -= L * self.n_experts * expert
        total += L * self.top_k * expert
        return total


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS: List[str] = [
    "zamba2-1.2b",
    "olmoe-1b-7b",
    "llama4-scout-17b-a16e",
    "qwen2-vl-7b",
    "whisper-medium",
    "tinyllama-1.1b",
    "smollm-360m",
    "yi-34b",
    "minitron-8b",
    "rwkv6-1.6b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable dry-run cell (assignment rules)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    return True, ""


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 256) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    nh = max(2, min(4, cfg.n_heads))
    nkv = max(1, min(nh, cfg.n_kv_heads if cfg.n_kv_heads else nh))
    while nh % nkv:
        nkv -= 1
    kw: Dict[str, Any] = dict(
        name=cfg.name + "-smoke",
        n_layers=layers,
        d_model=d_model,
        n_heads=nh,
        n_kv_heads=nkv,
        head_dim=d_model // nh,
        d_ff=d_model * 2,
        vocab_size=vocab,
        attn_chunk=32,
        fsdp=False,
        remat=False,
    )
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=min(2, cfg.top_k or 1))
    if cfg.family in ("hybrid", "ssm") or cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        kw.update(shared_attn_period=2)
    if cfg.family == "ssm":
        kw.update(rwkv_head_dim=16, rwkv_lora_dim=8)
    if cfg.n_encoder_layers:
        kw.update(n_encoder_layers=2)
    if cfg.n_frontend_tokens:
        kw.update(n_frontend_tokens=8)
    return replace(cfg, **kw)
