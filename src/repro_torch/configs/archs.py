"""Import-for-effect registry of the architectures the port carries so far:
the dense, moe, hybrid and rwkv families (the vlm and encdec configs come
with their families)."""
from repro_torch.configs import (  # noqa: F401
    h2o_danube_1_8b, llama3_2_3b, llama4_scout_17b_a16e, mistral_nemo_12b,
    mixtral_8x7b, rwkv6_7b, stablelm_3b, zamba2_2_7b,
)
