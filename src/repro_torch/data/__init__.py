"""Deterministic, checkpointable token streams (numpy only)."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataState, MemmapTokens, SyntheticTokens, make_dataset,
)
