"""Durable, crc-checked checkpoints of host arrays (the streaming replay
runner's)."""

from repro_torch.ckpt.store import (  # noqa: F401
    latest_step, load_checkpoint_raw, save_checkpoint,
)
