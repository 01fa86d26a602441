"""Straggler detection policy (paper-adjacent: the DES evaluates it too).

On a real pod each host reports step wall time; the controller flags ranks
whose EMA-normalized time is a robust outlier for ``patience`` consecutive
steps, then triggers mitigation (evict + elastic re-mesh, or re-shard).
Here the policy itself is the artifact, unit-tested on synthetic timings.
The port's copy of ``repro.runtime.straggler`` (plain Python).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List


@dataclasses.dataclass
class StragglerDecision:
    step: int
    rank: int
    ratio: float
    action: str  # "warn" | "evict"


class StragglerMonitor:
    def __init__(self, n_ranks: int = 1, *, window: int = 32,
                 warn_ratio: float = 1.3, evict_ratio: float = 2.0,
                 patience: int = 3):
        self.n_ranks = n_ranks
        self.window = window
        self.warn_ratio = warn_ratio
        self.evict_ratio = evict_ratio
        self.patience = patience
        self.hist: List[Deque[float]] = [deque(maxlen=window) for _ in range(n_ranks)]
        self.strikes: List[int] = [0] * n_ranks
        self.step = 0

    def update(self, per_rank_seconds) -> List[StragglerDecision]:
        """Feed one step's wall time per rank; returns decisions (may be [])."""
        self.step += 1
        if isinstance(per_rank_seconds, (int, float)):
            per_rank_seconds = [float(per_rank_seconds)]
        decisions: List[StragglerDecision] = []
        med = sorted(per_rank_seconds)[len(per_rank_seconds) // 2]
        for r, dt in enumerate(per_rank_seconds):
            self.hist[r].append(dt)
            base = sorted(self.hist[r])[len(self.hist[r]) // 2]
            ref = max(min(base, med), 1e-9)
            ratio = dt / ref
            if ratio >= self.warn_ratio and len(self.hist[r]) >= 4:
                self.strikes[r] += 1
            else:
                self.strikes[r] = 0
            if self.strikes[r] >= self.patience:
                action = "evict" if ratio >= self.evict_ratio else "warn"
                decisions.append(StragglerDecision(self.step, r, ratio, action))
                if action == "evict":
                    self.strikes[r] = 0
        return decisions

    def summary(self) -> Dict[str, float]:
        flat = [dt for h in self.hist for dt in h]
        if not flat:
            return {"mean_s": 0.0, "p95_s": 0.0}
        flat = sorted(flat)
        return {
            "mean_s": sum(flat) / len(flat),
            "p95_s": flat[int(0.95 * (len(flat) - 1))],
        }
