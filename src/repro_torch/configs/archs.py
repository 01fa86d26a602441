"""Import-for-effect registry of the architectures: every config of the
JAX package's registry, in the dense, moe, hybrid, rwkv, vlm and encdec
families."""
from repro_torch.configs import (  # noqa: F401
    h2o_danube_1_8b, llama3_2_3b, llama4_scout_17b_a16e, mistral_nemo_12b,
    mixtral_8x7b, qwen2_vl_72b, rwkv6_7b, seamless_m4t_medium, stablelm_3b,
    zamba2_2_7b,
)
