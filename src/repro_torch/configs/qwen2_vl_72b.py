"""qwen2-vl-72b — 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064,
M-RoPE (stubbed to 1-D RoPE; DESIGN.md §7), dynamic-resolution vision
frontend stubbed to precomputed patch embeddings. [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128, rope_theta=1_000_000.0,
    frontend="vision", frontend_frac=0.25,
))
