"""Logical-axis sharding rules and parameter definition trees."""

from repro_torch.sharding.rules import (  # noqa: F401
    ParamDef, ShardingRules, TRAIN_RULES, SERVE_RULES, LONG_DECODE_RULES,
    init_from_defs, shapes_from_defs, specs_from_defs, logical_to_pspec,
    constrain,
)
