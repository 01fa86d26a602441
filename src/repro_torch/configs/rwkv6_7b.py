"""rwkv6-7b (Finch) — 32L d=4096 attention-free, data-dependent decay,
d_ff=14336 vocab=65536. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65536, head_dim=64, rotary_pct=0.0,
))
