"""Allocation-span contention model of the PyTorch port (DESIGN.md §11.3).

Counterpart of ``repro.alloc.contention``.  A job spanning ``s`` topology
groups has its remaining runtime dilated at dispatch by

    dilated = remaining + (remaining * alpha_num * (s - 1)) // alpha_den

saturating at ``2**30 - 1``, with the reference's clamps, so every
intermediate stays inside int32 and the result is bit-exact.  Pinned as in
the reference: the dilation applies to ``remaining`` at each (re)dispatch
(a preempted job's leftover, already dilated, is dilated again under its
new span), and walltime estimates (``rsv_finish``, the shadow walk) are
never dilated.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

_LIM = 2 ** 30 - 1  # dilated runtimes saturate here (trace-horizon bound)


@dataclasses.dataclass(frozen=True)
class Contention:
    """Host ints, or int32 tensors of one entry per ensemble member."""

    enabled: Union[int, torch.Tensor]    # 0 = off, 1 = on
    alpha_num: Union[int, torch.Tensor]  # slowdown numerator per extra group
    alpha_den: Union[int, torch.Tensor]  # slowdown denominator, >= 1

    @classmethod
    def off(cls) -> "Contention":
        return cls(enabled=0, alpha_num=0, alpha_den=1)

    @classmethod
    def make(cls, alpha_num: int, alpha_den: int) -> "Contention":
        if not 0 < alpha_den < 2 ** 15:
            raise ValueError("alpha_den must be in [1, 2**15)")
        if not 0 <= alpha_num < 2 ** 10:
            raise ValueError("alpha_num must be in [0, 2**10)")
        return cls(enabled=1, alpha_num=int(alpha_num),
                   alpha_den=int(alpha_den))

    @classmethod
    def canonical(cls, value) -> "Contention":
        """``None`` -> off, ``(num, den)`` -> :meth:`make`, a
        ``Contention`` passes through."""
        if value is None:
            return cls.off()
        if isinstance(value, tuple):
            return cls.make(*value)
        if not isinstance(value, cls):
            raise TypeError(
                f"contention must be None, (num, den), or Contention; "
                f"got {type(value).__name__}")
        return value

    @classmethod
    def stack(cls, cons, device) -> "Contention":
        """One ``Contention`` of i32[M] tensors from M host ones."""
        def col(f):
            return torch.tensor([int(getattr(c, f)) for c in cons],
                                dtype=torch.int32).to(device)
        return cls(enabled=col("enabled"), alpha_num=col("alpha_num"),
                   alpha_den=col("alpha_den"))


def dilate(con: Contention, remaining: torch.Tensor,
           span: torch.Tensor) -> torch.Tensor:
    """Dilated runtime (int32) for an allocation spanning ``span`` groups.

    ``factor = alpha_num * (span - 1) < 2**25``; ``remaining`` is clamped so
    that the product stays below ``2**30``.  A host ``enabled`` of 0
    returns ``remaining`` without an operation."""
    if isinstance(con.enabled, int) and not con.enabled:
        return remaining
    factor = con.alpha_num * torch.clamp(span - 1, min=0)
    safe_rem = torch.minimum(remaining, _LIM // torch.clamp(factor, min=1))
    extra = (safe_rem * factor) // con.alpha_den
    dilated = torch.clamp(remaining + extra, max=_LIM).to(torch.int32)
    if isinstance(con.enabled, int):
        return dilated
    return torch.where(con.enabled > 0, dilated, remaining)


def dilate_host(alpha_num: int, alpha_den: int, remaining: int,
                span: int) -> int:
    """Host mirror of :func:`dilate` (plain Python ints, same clamping)."""
    factor = alpha_num * max(span - 1, 0)
    safe_rem = min(remaining, _LIM // max(factor, 1))
    return min(remaining + (safe_rem * factor) // alpha_den, _LIM)
