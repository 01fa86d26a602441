"""AdamW and int8 gradient compression with error feedback, on trees of
tensors."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, OptState, adamw_init, adamw_update, cosine_schedule,
    global_norm,
)
from repro_torch.optim.compression import (  # noqa: F401
    CompressionState, compress_gradients, compression_init, payload_bytes,
)
