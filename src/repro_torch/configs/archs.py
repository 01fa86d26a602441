"""Import-for-effect registry of the architectures the port carries so far:
the dense family and rwkv (the moe, hybrid, vlm and encdec configs come
with their families)."""
from repro_torch.configs import (  # noqa: F401
    h2o_danube_1_8b, llama3_2_3b, mistral_nemo_12b, rwkv6_7b, stablelm_3b,
)
