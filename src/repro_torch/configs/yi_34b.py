"""yi-34b — llama-arch GQA, 34B dense. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    fsdp=True, fsdp_inference=True,  # 34B params: 2D weight sharding
    microbatches=8,
    source="arXiv:2403.04652; hf",
)
