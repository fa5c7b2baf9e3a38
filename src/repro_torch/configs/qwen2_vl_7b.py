"""qwen2-vl-7b — M-RoPE, dynamic-resolution VLM (vision frontend stubbed).
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    pos_type="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="vision", n_frontend_tokens=256,
    microbatches=4,
    source="arXiv:2409.12191; hf",
)
