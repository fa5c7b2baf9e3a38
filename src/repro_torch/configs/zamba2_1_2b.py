"""zamba2-1.2b — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    shared_attn_period=6,  # shared attn+mlp block invoked every 6 mamba layers
    subquadratic=True,     # mamba backbone dominates; shared-attn KV is SP-sharded
    microbatches=4,
    tie_embeddings=True,
    source="arXiv:2411.15242; hf",
)
