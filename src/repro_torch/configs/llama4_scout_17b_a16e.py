"""llama4-scout-17b-16e — 16-expert top-1 MoE + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=16, top_k=1, n_shared_experts=1, qk_norm=True,
    frontend="vision", n_frontend_tokens=256,  # early-fusion image patches (stub)
    fsdp=True, fsdp_inference=True,  # ~109B total params: 2D weight sharding required
    microbatches=8,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
