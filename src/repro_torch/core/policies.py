"""Scheduling-policy selectors of the PyTorch engine.

Counterpart of ``repro.core.policies``, with the same semantics: each
selector returns the row of the waiting job that starts next, or -1.

- FCFS / SJF / LJF: blocking head of the (re)ordered queue.
- BestFit: among waiting jobs that fit, the one leaving the fewest nodes
  free (ties: FCFS order).
- Backfill: EASY.  The FCFS head starts if it fits; otherwise the first
  FCFS-ordered waiting job that fits now and either ends by the head's
  shadow time or uses only the shadow's extra nodes.
- Preempt: queue order (priority, submit, row); the head starts if it fits
  in the free nodes plus those of strictly-lower-priority running jobs.

Every argmin is a ``queue_select`` call (the Hopper kernel on a CUDA
tensor), whose contract is the first index attaining the minimum.  The
reference's device ``while_loop``s become host loops that read the
kernel's ``(index, score)`` pair once per selection.  Selectors return
Python ints.  Every primary key passed to ``_lex_argmin`` here (submit,
estimate, -estimate, free - nodes, reservation times) stays below ``BIG``,
where ``queue_select`` and the reference's jnp argmin agree exactly.
"""

from __future__ import annotations

import torch

from repro_torch.core.jobs import INF_TIME, RUNNING, WAITING, JobSet, SimState
from repro_torch.kernels.queue_select.ops import queue_select

_BIG = INF_TIME


def _lex_min(primary: torch.Tensor, mask: torch.Tensor) -> tuple[int, int]:
    """(index minimizing (primary, index) over ``mask``, that primary);
    ``(-1, BIG)`` if the mask is empty.  One host read per call."""
    idx, score = queue_select(primary, mask).tolist()
    return idx, score


def _lex_argmin(primary: torch.Tensor, mask: torch.Tensor) -> int:
    """Index minimizing (primary, index) over ``mask``; -1 if mask empty."""
    return _lex_min(primary, mask)[0]


def backfill_shadow(jobs: JobSet, state: SimState,
                    head_need: int) -> tuple[int, int, int]:
    """EASY shadow reservation for a blocked head needing ``head_need``
    nodes: ``(shadow, extra, k_row)``.

    Walks the running jobs' releases (walltime estimates, clamped past the
    clock) in (time, row) order, adding their nodes to the free count until
    the head is covered.  ``shadow`` is that release time, ``extra`` the
    spare nodes then, ``k_row`` the release that covered the head (-1, with
    ``shadow = BIG`` and ``extra = free``, when the running set cannot).  As
    in the reference, at least one release is always counted.
    """
    running = state.jstate == RUNNING
    rsv = torch.where(running,
                      torch.clamp(state.rsv_finish, min=state.clock + 1), _BIG)
    nodes = jobs.host["nodes"]
    left = running.clone()
    cum, sh, k_row = state.free, _BIG, -1
    while True:
        i, score = _lex_min(rsv, left)
        if i < 0:
            break
        cum, sh, k_row = cum + int(nodes[i]), score, i
        left[i] = False
        if cum >= head_need:
            break
    if k_row >= 0 and cum >= head_need:
        return sh, cum - head_need, k_row
    return _BIG, state.free, -1


def _blocking_head(jobs: JobSet, state: SimState, key: torch.Tensor,
                   cap: int) -> int:
    head = _lex_argmin(key, state.jstate == WAITING)
    if head >= 0 and int(jobs.host["nodes"][head]) <= cap:
        return head
    return -1


def select_fcfs(jobs: JobSet, state: SimState, cap: int) -> int:
    return _blocking_head(jobs, state, jobs.submit, cap)


def select_sjf(jobs: JobSet, state: SimState, cap: int) -> int:
    return _blocking_head(jobs, state, jobs.estimate, cap)


def select_ljf(jobs: JobSet, state: SimState, cap: int) -> int:
    return _blocking_head(jobs, state, -jobs.estimate, cap)


def select_bestfit(jobs: JobSet, state: SimState, cap: int) -> int:
    feasible = (state.jstate == WAITING) & (jobs.nodes <= cap)
    return _lex_argmin(state.free - jobs.nodes, feasible)


def select_backfill(jobs: JobSet, state: SimState, cap: int) -> int:
    waiting = state.jstate == WAITING
    head = _lex_argmin(jobs.submit, waiting)
    if head < 0:
        return -1
    head_need = int(jobs.host["nodes"][head])
    if head_need <= cap:
        return head
    # some non-head waiting job must fit before the shadow walk can pay
    others = waiting & (jobs.nodes <= cap)
    others[head] = False
    if not bool(torch.any(others)):
        return -1
    shadow, extra, _k_row = backfill_shadow(jobs, state, head_need)
    ends_by_shadow = (jobs.estimate + state.clock) <= shadow
    within_extra = jobs.nodes <= min(state.free, extra)
    return _lex_argmin(jobs.submit, others & (ends_by_shadow | within_extra))


def select_preempt(jobs: JobSet, state: SimState, cap: int) -> int:
    """Priority scheduling with preemption; ``cap`` is unused (the reclaim
    test counts free nodes).  Both stages are ``queue_select`` calls: the
    least priority over the waiting jobs (the reference's
    ``min(where(waiting, priority, BIG))``, taken over every row so that it
    agrees for priorities above ``BIG`` too), then the FCFS head of that
    tier."""
    waiting = state.jstate == WAITING
    p = torch.where(waiting, jobs.priority, _BIG)
    _, best_p = _lex_min(p, torch.ones_like(waiting))
    head = _lex_argmin(jobs.submit, waiting & (jobs.priority == best_p))
    if head < 0:
        return -1
    lower = (state.jstate == RUNNING) & (jobs.priority
                                         > int(jobs.host["priority"][head]))
    reclaimable = int(torch.sum(torch.where(lower, jobs.nodes, 0)))
    if int(jobs.host["nodes"][head]) <= state.free + reclaimable:
        return head
    return -1


# indexed by policy id (FCFS, SJF, LJF, BESTFIT, BACKFILL, PREEMPT)
SELECTORS = (select_fcfs, select_sjf, select_ljf, select_bestfit,
             select_backfill, select_preempt)


def select(policy: int, jobs: JobSet, state: SimState,
           cap: int | None = None) -> int:
    """Dispatch on the policy id, clamped to the table as in the reference;
    ``cap`` defaults to the free counter."""
    cap = state.free if cap is None else cap
    return SELECTORS[min(max(int(policy), 0), len(SELECTORS) - 1)](
        jobs, state, cap)
