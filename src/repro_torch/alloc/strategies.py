"""Node-placement strategies of the PyTorch port (DESIGN.md §11.2).

Counterpart of ``repro.alloc.strategies``, with the same pinned
tie-breaks.  Each strategy answers two questions against the occupancy map
``owner`` (i32, ``-1`` = free, else the owning job row):

1. *feasibility*: a ``need``-node job can be placed iff ``need <=
   placeable_cap``: the free-node count for ``simple``, ``spread`` and
   ``topo``, the largest free run for ``contiguous``;
2. *placement*: ``place`` returns a bool mask with exactly ``need`` set
   bits whenever ``need`` free nodes exist.

- ``simple``     the ``need`` lowest-id free nodes.
- ``contiguous`` the maximal free run minimizing (run length, start id);
                 its first ``need`` nodes.  Falls back to ``simple`` when
                 no run fits (only the preempt policy, whose reclaim test
                 counts nodes, gets there).
- ``spread``     free nodes ordered by (rank within group, group id, node
                 id), the first ``need``.
- ``topo``       groups by (free count desc, group id), nodes within a
                 group by id, the first ``need``.

Every function takes ``owner`` as ``[..., N]``: a solo run's ``[N]`` map, or
``[M, N]`` rows of an ensemble, one placement a row (``need`` then has one
entry a row).  Everything stays int32, with the reference's ``2**30 - 1``
sentinel.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.alloc.machine import Machine

SIMPLE = 0
CONTIGUOUS = 1
SPREAD = 2
TOPO = 3

ALLOC_NAMES = {SIMPLE: "simple", CONTIGUOUS: "contiguous", SPREAD: "spread",
               TOPO: "topo"}
ALLOC_IDS = {v: k for k, v in ALLOC_NAMES.items()}

_BIG = 2 ** 30 - 1


def alloc_id(strategy) -> int:
    if isinstance(strategy, str):
        try:
            return ALLOC_IDS[strategy.lower()]
        except KeyError:
            raise ValueError(
                f"unknown allocation strategy {strategy!r}; "
                f"known: {sorted(ALLOC_IDS)}") from None
    return int(strategy)


def canonical_id(strategy):
    """The strategy canonicalizer of every entry point.

    A name, a dense id or a numpy/torch integer scalar gives a plain
    ``int``; a sequence of those (list, tuple, numpy array, including
    object/str arrays, or a torch tensor) gives a list of ints; ``None``
    gives ``SIMPLE``.  Every id is checked against the strategy table."""
    import numpy as np

    if strategy is None:
        return SIMPLE
    if isinstance(strategy, torch.Tensor):
        strategy = strategy.cpu().numpy()
    if isinstance(strategy, (list, tuple)):
        return [canonical_id(s) for s in strategy]
    if isinstance(strategy, np.ndarray):
        if strategy.ndim == 0:
            return canonical_id(strategy.item())
        return [canonical_id(s) for s in strategy.tolist()]
    sid = alloc_id(strategy)
    if sid not in ALLOC_NAMES:
        raise ValueError(
            f"allocation strategy id {sid} out of range; "
            f"known: {sorted(ALLOC_NAMES)}")
    return sid


@functools.lru_cache(maxsize=None)
def _ids(n: int, device: torch.device) -> torch.Tensor:
    """i32[n] ``0..n-1`` on ``device``, made once."""
    return torch.arange(n, dtype=torch.int32, device=device)


def _col(need):
    """``need`` broadcast against ``[..., N]``: an int, or one entry a
    row."""
    if isinstance(need, torch.Tensor) and need.dim() > 0:
        return need.unsqueeze(-1)
    return need


# ---------------------------------------------------------------------------
# occupancy-map scalars
# ---------------------------------------------------------------------------


def free_count(owner: torch.Tensor) -> torch.Tensor:
    return torch.sum(owner < 0, dim=-1, dtype=torch.int32)


def _runs(owner: torch.Tensor, ii: torch.Tensor):
    """(free, last busy id before each node (-1: none), run length ending
    at each free node (0 at busy ones))."""
    free = owner < 0
    prev_busy = torch.cummax(torch.where(free, -1, ii), dim=-1).values
    return free, prev_busy, torch.where(free, ii - prev_busy, 0)


def largest_free_run(owner: torch.Tensor) -> torch.Tensor:
    """Length of the longest run of consecutive free nodes."""
    ii = _ids(owner.shape[-1], owner.device)
    return torch.amax(_runs(owner, ii)[2], dim=-1)


def placeable_cap(strategy: int, owner: torch.Tensor) -> torch.Tensor:
    """Largest job size placeable right now: ``need <= cap`` iff
    feasible."""
    if min(max(int(strategy), 0), 3) == CONTIGUOUS:
        return largest_free_run(owner)
    return free_count(owner)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _take_first(order: torch.Tensor, free: torch.Tensor, need) -> torch.Tensor:
    """Mask of the first ``need`` *free* rows of ``order`` (a permutation
    that sorts free nodes first by preference key)."""
    take = _ids(order.shape[-1], order.device) < _col(need)
    take = take.expand(order.shape)
    return torch.zeros_like(free).scatter_(-1, order, take) & free


def _place_simple(machine: Machine, owner: torch.Tensor, need):
    free = owner < 0
    rank = torch.cumsum(free, -1, dtype=torch.int32)
    return free & (rank <= _col(need))


def _place_contiguous(machine: Machine, owner: torch.Tensor, need):
    n = owner.shape[-1]
    ii = _ids(n, owner.device)
    free, prev_busy, run_len = _runs(owner, ii)
    run_start = prev_busy + 1
    nxt_free = torch.cat([free[..., 1:], torch.zeros_like(free[..., :1])],
                         dim=-1)
    run_end = free & ~nxt_free
    feasible = run_end & (run_len >= _col(need))
    # best fit: least (run length, start id); a run's start identifies it,
    # so the key is collision-free among the feasible rows
    key = torch.where(feasible, run_len * (n + 1) + run_start, _BIG)
    best = torch.argmin(key, dim=-1, keepdim=True)
    start = torch.gather(run_start, -1, best)
    block = (ii >= start) & (ii < start + _col(need))
    found = torch.any(feasible, dim=-1, keepdim=True)
    return torch.where(found, block, _place_simple(machine, owner, need))


def _group_base(machine: Machine, csum: torch.Tensor) -> torch.Tensor:
    """Per-node cumulative count just *before* the node's group starts."""
    return torch.where(machine.in_first_group, 0,
                       csum[..., machine.before_group])


def _place_spread(machine: Machine, owner: torch.Tensor, need):
    free = owner < 0
    csum = torch.cumsum(free, -1, dtype=torch.int32)
    rank_in_group = csum - _group_base(machine, csum)   # 1-based among free
    key = torch.where(free, (rank_in_group - 1) * machine.n_groups
                      + machine.group, _BIG)
    order = torch.sort(key, dim=-1, stable=True)[1]   # ties by node id
    return _take_first(order, free, need)


def _place_topo(machine: Machine, owner: torch.Tensor, need):
    free = owner < 0
    n = owner.shape[-1]
    csum = torch.cumsum(free, -1, dtype=torch.int32)
    group_free = csum[..., machine.group_last] - _group_base(machine, csum)
    key = torch.where(free, (n - group_free) * machine.n_groups
                      + machine.group, _BIG)
    order = torch.sort(key, dim=-1, stable=True)[1]   # within group by id
    return _take_first(order, free, need)


_PLACERS = (_place_simple, _place_contiguous, _place_spread, _place_topo)


def place(strategy: int, machine: Machine, owner: torch.Tensor,
          need) -> torch.Tensor:
    """Choose ``need`` free nodes; guaranteed to succeed iff they exist."""
    return _PLACERS[min(max(int(strategy), 0), 3)](machine, owner, need)


def place_batch(strategies, machine: Machine, owner: torch.Tensor,
                need: torch.Tensor) -> torch.Tensor:
    """:func:`place` for each row of ``owner`` (``[M, N]``) under its own
    strategy (``strategies``: M host ints) and ``need`` (i32[M]): one call
    of each placer that some row uses, over those rows."""
    sids = [min(max(int(s), 0), 3) for s in strategies]
    if len(set(sids)) == 1:
        return _PLACERS[sids[0]](machine, owner, need)
    mask = torch.empty(owner.shape, dtype=torch.bool, device=owner.device)
    for s in sorted(set(sids)):
        rows = torch.tensor([i for i, t in enumerate(sids) if t == s]).to(
            owner.device)
        mask[rows] = _PLACERS[s](machine, owner[rows], need[rows])
    return mask


# ---------------------------------------------------------------------------
# locality score + fingerprints
# ---------------------------------------------------------------------------


def group_span(machine: Machine, mask: torch.Tensor) -> torch.Tensor:
    """Number of distinct topology groups the allocation touches: the
    groups with a node in ``mask`` (``machine.group_table`` gathers each
    group's nodes, its padding reads a False past the last node)."""
    padded = torch.nn.functional.pad(mask, (0, 1))
    touched = torch.any(padded[..., machine.group_table], dim=-1)
    return torch.sum(touched, dim=-1, dtype=torch.int32)


def alloc_fingerprint(mask: torch.Tensor):
    """(lowest node id, sum of 1-based node ids): an exact-equality witness
    for cross-engine node-map validation (DESIGN.md §11.4)."""
    ii = _ids(mask.shape[-1] + 1, mask.device)
    first = torch.amin(torch.where(mask, ii[:-1], _BIG), dim=-1)
    asum = torch.sum(torch.where(mask, ii[1:], 0), dim=-1, dtype=torch.int32)
    return first, asum
