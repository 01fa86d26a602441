"""Family-dispatching facade over the port's models: counterpart of
``repro.models.api``, with ``loss_fn`` for training and
``prefill``/``decode_step`` for serving.  The encoder-decoder family is
``models.encdec``, every other family ``models.lm``.  Each entry takes
``rules=`` and ``mesh=`` (the sharded layout: DTensor parameters placed by
``param_specs``), as the reference's do."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.sharding.rules import (
    ShardingRules, count_params, init_from_defs, shapes_from_defs,
    specs_from_defs,
)


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

    def param_shapes(self):
        """Meta-device tensors of the leaves' shapes: no allocation."""
        return shapes_from_defs(self.param_defs)

    def param_specs(self, rules: ShardingRules, mesh):
        """Each leaf's DTensor placements on ``mesh`` under ``rules``."""
        return specs_from_defs(self.param_defs, rules, mesh)

    def n_params(self) -> int:
        return count_params(self.param_defs)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "encdec":
        # the reference's cache_defs_fn: a source of half the length; its
        # prefill returns full logits and no cache, the port's the last
        # position's logits and the decode cache
        return ModelAPI(
            cfg=cfg,
            param_defs=encdec.param_defs(cfg),
            loss_fn=lambda p, b, **kw: encdec.loss_fn(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: encdec.prefill(p, b, cfg, **kw),
            decode_step=lambda p, t, pos, c, **kw: encdec.decode_step(
                p, t, pos, c, cfg, **kw),
            cache_defs_fn=lambda batch, seq: encdec.cache_defs(
                cfg, batch, seq, max(seq // 2, 1)),
        )
    return ModelAPI(
        cfg=cfg,
        param_defs=lm.param_defs(cfg),
        loss_fn=lambda p, b, **kw: lm.loss_fn(p, b, cfg, **kw),
        prefill=lambda p, b, **kw: lm.prefill(p, b, cfg, **kw),
        decode_step=lambda p, t, pos, c, **kw: lm.decode_step(
            p, t, pos, c, cfg, **kw),
        cache_defs_fn=lambda batch, seq: lm.cache_defs(cfg, batch, seq),
    )
