"""Import-for-effect registry of the dense-family architectures the port
carries so far (the moe, hybrid, rwkv, vlm and encdec configs come with
their families)."""
from repro_torch.configs import (  # noqa: F401
    h2o_danube_1_8b, llama3_2_3b, mistral_nemo_12b, stablelm_3b,
)
