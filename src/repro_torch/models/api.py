"""Family-dispatching facade over the port's models (the dense, moe,
hybrid and rwkv families so far): counterpart of ``repro.models.api``,
with ``loss_fn`` for training and ``prefill``/``decode_step`` for
serving."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.sharding.rules import count_params, init_from_defs


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    param_defs: Any
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    cache_defs_fn: Callable

    def init(self, generator: torch.Generator) -> lm.LM:
        """Random parameters on ``generator``'s device."""
        return lm.LM(init_from_defs(self.param_defs, generator))

    def n_params(self) -> int:
        return count_params(self.param_defs)


def get_model(cfg: ModelConfig) -> ModelAPI:
    lm.require_ported(cfg)
    return ModelAPI(
        cfg=cfg,
        param_defs=lm.param_defs(cfg),
        loss_fn=lambda p, b: lm.loss_fn(p, b, cfg),
        prefill=lambda p, b: lm.prefill(p, b, cfg),
        decode_step=lambda p, t, pos, c: lm.decode_step(p, t, pos, c, cfg),
        cache_defs_fn=lambda batch, seq: lm.cache_defs(cfg, batch, seq),
    )
