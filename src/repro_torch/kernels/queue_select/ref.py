"""Plain PyTorch version of ``queue_select``: masked lexicographic argmin."""

from __future__ import annotations

import torch

BIG = 2**30 - 1


def queue_select_reference(scores: torch.Tensor,
                           feasible: torch.Tensor) -> torch.Tensor:
    """i32[2] = (first index attaining the minimum feasible score, that
    score), or ``(-1, BIG)`` when nothing is feasible.

    Two-stage min (the value, then the lowest index attaining it), so the
    answer never depends on which index ``torch.argmin`` returns on ties.
    A feasible entry scoring ``BIG`` or more is still found.
    """
    feas = feasible.to(torch.bool)
    rows = torch.arange(scores.shape[0], dtype=torch.int32,
                        device=scores.device)
    best = torch.min(torch.where(feas, scores, torch.iinfo(torch.int32).max))
    idx = torch.min(torch.where(feas & (scores == best), rows, BIG))
    found = torch.any(feas)
    return torch.stack([torch.where(found, idx, -1),
                        torch.where(found, best, BIG)]).to(torch.int32)
