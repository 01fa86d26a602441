"""Durable, crc-checked checkpoints of host arrays (the streaming replay
runner's and the trainer's)."""

from repro_torch.ckpt.store import (  # noqa: F401
    CheckpointManager, latest_step, load_checkpoint, load_checkpoint_raw,
    save_checkpoint,
)
