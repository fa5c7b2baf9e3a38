"""whisper-medium — enc-dec, conv audio frontend (stub). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    n_encoder_layers=24, pos_type="learned", act="gelu", norm="layernorm",
    frontend="audio", n_frontend_tokens=1500,  # precomputed log-mel frame embeddings
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)
