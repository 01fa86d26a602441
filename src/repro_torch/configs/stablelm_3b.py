"""stablelm-3b — 32L d=2560 32H (MHA kv=32) d_ff=6912 vocab=50304,
LayerNorm + 25% partial rotary. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab=50304, head_dim=80, norm="layernorm", rotary_pct=0.25,
    rope_theta=10_000.0,
))
