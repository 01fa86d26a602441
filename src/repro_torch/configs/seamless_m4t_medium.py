"""seamless-m4t-medium — enc-dec, 12+12L d=1024 16H (kv=16) d_ff=4096
vocab=256206, audio frontend stubbed to precomputed frame embeddings.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64, norm="layernorm", act="gelu",
    rope_theta=10_000.0,
))
