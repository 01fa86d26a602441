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

Every argmin is one fused selection of the job table's ``selector``: the
``queue_select`` kernel builds the key and the mask of a mode from the
table's columns and the job states, and returns ``(index, score)`` as
Python ints (the plain version on a CPU table).  The shadow walk is one
``shadow_walk`` launch.  The reference's device ``while_loop``s become host
loops over these calls.  Every primary key here (submit, estimate,
-estimate, free - nodes, reservation times) stays below ``BIG``, where the
kernel and the reference's jnp argmin agree exactly.
"""

from __future__ import annotations

import torch

from repro_torch.core.jobs import RUNNING, JobSet, SimState
from repro_torch.kernels.queue_select import ref
from repro_torch.kernels.queue_select.ops import shadow_walk


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
    return shadow_walk(jobs.selector, state.jstate, state.rsv_finish,
                       state.clock, state.free, head_need)


def _blocking_head(jobs: JobSet, state: SimState, mode: int, cap: int) -> int:
    head, _ = jobs.selector.select(mode, state.jstate)
    if head >= 0 and int(jobs.host["nodes"][head]) <= cap:
        return head
    return -1


def select_fcfs(jobs: JobSet, state: SimState, cap: int) -> int:
    return _blocking_head(jobs, state, ref.HEAD_SUBMIT, cap)


def select_sjf(jobs: JobSet, state: SimState, cap: int) -> int:
    return _blocking_head(jobs, state, ref.HEAD_ESTIMATE, cap)


def select_ljf(jobs: JobSet, state: SimState, cap: int) -> int:
    return _blocking_head(jobs, state, ref.HEAD_NEG_ESTIMATE, cap)


def select_bestfit(jobs: JobSet, state: SimState, cap: int) -> int:
    return jobs.selector.select(ref.BESTFIT, state.jstate, free=state.free,
                                cap=cap)[0]


def select_backfill(jobs: JobSet, state: SimState, cap: int) -> int:
    sel = jobs.selector
    head, _ = sel.select(ref.HEAD_SUBMIT, state.jstate)
    if head < 0:
        return -1
    head_need = int(jobs.host["nodes"][head])
    if head_need <= cap:
        return head
    # some non-head waiting job must fit before the shadow walk can pay
    if sel.select(ref.ANY_FIT, state.jstate, cap=cap, exclude=head)[0] < 0:
        return -1
    shadow, extra, _k_row = backfill_shadow(jobs, state, head_need)
    return sel.select(ref.BACKFILL_CAND, state.jstate, clock=state.clock,
                      free=state.free, cap=cap, shadow=shadow, extra=extra,
                      exclude=head)[0]


def select_preempt(jobs: JobSet, state: SimState, cap: int) -> int:
    """Priority scheduling with preemption; ``cap`` is unused (the reclaim
    test counts free nodes).  Both stages are fused selections: the least
    priority over the waiting jobs (the reference's
    ``min(where(waiting, priority, BIG))``, taken over every row so that it
    agrees for priorities above ``BIG`` too), then the FCFS head of that
    tier."""
    sel = jobs.selector
    _, best_p = sel.select(ref.PREEMPT_TIER, state.jstate)
    head, _ = sel.select(ref.PREEMPT_HEAD, state.jstate, tier=best_p)
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
