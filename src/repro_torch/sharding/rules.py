"""Parameter definition trees.

Counterpart of the parameter-tree half of ``repro.sharding.rules``.  A
model declares its parameters once, as a nested dict of :class:`ParamDef`
leaves (shape, logical axes, initializer, dtype); the same tree yields the
initialized tensors, their meta-device stand-ins and the parameter count.
The logical axes are kept for a later sharded layout; on one device they
have no job.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes + initializer."""

    shape: Tuple[int, ...]
    axes: Axes
    init: str = "normal"      # normal | zeros | ones | embed
    scale: Optional[float] = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")

    def std(self) -> float:
        """The normal initializer's standard deviation: fan-in scaling on
        the contracting dim, 1.0 for embeddings, unless ``scale`` is set."""
        if self.scale is not None:
            return self.scale
        if self.init == "embed":
            return 1.0
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return fan_in ** -0.5


def map_defs(fn: Callable[[ParamDef], Any], defs):
    """Apply ``fn`` to every ``ParamDef`` of a nested dict, in sorted key
    order (the order JAX flattens a dict in), keeping the tree's shape."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, defs[k]) for k in sorted(defs)}


def leaves(defs) -> list:
    out = []
    map_defs(out.append, defs)
    return out


def _leaf_init(d: ParamDef, generator: torch.Generator) -> torch.Tensor:
    device = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init in ("normal", "embed"):
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        # scaled in place: a stacked expert leaf is tens of GB at full width
        return x.mul_(d.std()).to(d.dtype)
    raise ValueError(f"unknown init {d.init!r}")


def init_from_defs(defs, generator: torch.Generator):
    """Initialize a tree of ParamDefs on ``generator``'s device, drawing
    the leaves one after another from ``generator``.  The scaling is the
    JAX package's; the numbers are torch's own."""
    return map_defs(lambda d: _leaf_init(d, generator), defs)


def shapes_from_defs(defs):
    """Meta-device tensors of each leaf's shape and dtype: no allocation."""
    return map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for d in leaves(defs))
