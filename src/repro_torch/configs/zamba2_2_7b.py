"""zamba2-2.7b — 54L d=2560 Mamba2 backbone (ssm_state=64) with one shared
attention+MLP block applied every 6 layers (32H kv=32, d_ff=10240).
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80, rope_theta=10_000.0,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
))
