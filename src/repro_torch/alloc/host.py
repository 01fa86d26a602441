"""Host-side (numpy) mirror of the placement strategies (DESIGN.md §11.4).

Counterpart of ``repro.alloc.host``.  ``repro_torch.refsim`` validates the
engine per job *and* per node; these functions reproduce the tie-breaks of
``repro_torch.alloc.strategies`` exactly, written as straightforward scans
so that the two implementations fail independently.

``owner`` is the same i32[N] occupancy map (-1 = free).  Placement returns a
sorted array of node ids (the mask's set bits).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.alloc.strategies import (
    CONTIGUOUS, SIMPLE, SPREAD, TOPO, alloc_id,
)


def free_count_host(owner: np.ndarray) -> int:
    return int((owner < 0).sum())


def largest_free_run_host(owner: np.ndarray) -> int:
    best = run = 0
    for busy in owner >= 0:
        run = 0 if busy else run + 1
        best = max(best, run)
    return best


def placeable_cap_host(strategy, owner: np.ndarray) -> int:
    if alloc_id(strategy) == CONTIGUOUS:
        return largest_free_run_host(owner)
    return free_count_host(owner)


def _runs(owner: np.ndarray):
    """Maximal free runs as (length, start) tuples in start order."""
    runs, start = [], None
    for i, busy in enumerate(owner >= 0):
        if busy:
            if start is not None:
                runs.append((i - start, start))
                start = None
        elif start is None:
            start = i
    if start is not None:
        runs.append((len(owner) - start, start))
    return runs


def place_host(strategy, mach: Dict[str, np.ndarray], owner: np.ndarray,
               need: int) -> np.ndarray:
    """Mirror of ``strategies.place``: ids of the chosen ``need`` nodes."""
    sid = alloc_id(strategy)
    free_ids = np.nonzero(owner < 0)[0]
    if sid == SIMPLE:
        return free_ids[:need]
    if sid == CONTIGUOUS:
        fits = [r for r in _runs(owner) if r[0] >= need]
        if not fits:  # preempt-policy fallback, pinned identically in JAX
            return free_ids[:need]
        length, start = min(fits)
        return np.arange(start, start + need)
    group = mach["group"]
    if sid == SPREAD:
        # (rank among free within group, group id, node id)
        rank: Dict[int, int] = {}
        keyed = []
        for i in free_ids:
            g = int(group[i])
            rank[g] = rank.get(g, 0) + 1
            keyed.append((rank[g], g, int(i)))
        keyed.sort()
        return np.array(sorted(k[2] for k in keyed[:need]), dtype=np.int64)
    if sid == TOPO:
        # groups by (free count desc, group id), nodes within a group by id
        per_group: Dict[int, list] = {}
        for i in free_ids:
            per_group.setdefault(int(group[i]), []).append(int(i))
        order = sorted(per_group, key=lambda g: (-len(per_group[g]), g))
        chosen: list = []
        for g in order:
            chosen.extend(per_group[g])
        return np.array(sorted(chosen[:need]), dtype=np.int64)
    raise ValueError(f"unknown allocation strategy {strategy!r}")


def group_span_host(mach: Dict[str, np.ndarray], node_ids: np.ndarray) -> int:
    return len(np.unique(mach["group"][node_ids])) if len(node_ids) else 0


def fingerprint_host(node_ids: np.ndarray) -> tuple[int, int]:
    """(lowest node id, sum of 1-based ids); mirrors ``alloc_fingerprint``."""
    if len(node_ids) == 0:
        return int(2 ** 30 - 1), 0
    return int(node_ids.min()), int((node_ids + 1).sum())
