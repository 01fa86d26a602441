"""The discrete-event engine of the PyTorch port (scalar-counter mode).

Counterpart of ``repro.core.engine`` with ``machine``, ``failures``,
``service`` and ``malleable`` all ``None`` and no dependency edges.  Event
semantics are the reference's:

  1. advance the clock to min(next arrival, next completion),
  2. process every completion with finish <= clock (reclaim nodes),
  3. process every arrival with submit <= clock (enqueue),
  4. run the scheduling pass: start jobs until the policy blocks.

PyTorch has no device-side while loop, so the host drives both loops.  The
per-job state stays on the device and is updated in place; the host keeps
the clock, the free-node counter and the event count, and reads one small
tensor per event (clock, freed nodes, completions) plus one ``(index,
score)`` pair per selection.  The scheduling pass is the reference's: for
backfill the batched pass ``_batched_backfill_pass`` (one shadow walk per
event, DESIGN.md §18), for the other five policies the per-start selector
loop (``_fast_order`` picks, as in ``repro.api.run`` on tables without
dependency edges).  All paths are bit-identical.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import policies
from repro_torch.core.jobs import (
    BACKFILL, DONE, FCFS, INF_TIME, LJF, PENDING, POLICY_IDS, PREEMPT, RUNNING,
    SJF, WAITING, JobSet, SimResult, SimState, resolve_device,
    result_from_state,
)
from repro_torch.kernels.queue_select import ref as select_ref
from repro_torch.kernels.queue_select.ops import shadow_walk

# Counts of the batched backfill pass, for the on-card checks: shadow-walk
# recomputations after an overdraw of ``extra`` (``redo``), and the most walk
# launches one event made besides those (``max_walks_per_event``).
counters = {"redo": 0, "max_walks_per_event": 0}


def reset_counters() -> None:
    counters.update(redo=0, max_walks_per_event=0)


def _start_job(jobs: JobSet, state: SimState, idx: int) -> SimState:
    """Start job ``idx`` now: schedule its completion from its remaining
    runtime, and record only its FIRST start time."""
    clock = state.clock
    state.jstate[idx] = RUNNING
    state.start[idx : idx + 1].clamp_(max=clock)
    state.finish[idx : idx + 1] = state.remaining[idx : idx + 1] + clock
    state.rsv_finish[idx] = clock + int(jobs.host["estimate"][idx])
    state.free -= int(jobs.host["nodes"][idx])
    return state


def _preempt_for(jobs: JobSet, state: SimState, idx: int) -> SimState:
    """Suspend the minimal set of strictly-lower-priority running jobs so
    that job ``idx`` fits.  Victims go most-preemptible-first, (priority
    desc, row desc): two stable sorts, the secondary key first.  Suspended
    jobs keep their elapsed work and return to WAITING."""
    J = jobs.capacity
    need = int(jobs.host["nodes"][idx]) - state.free
    lower = (state.jstate == RUNNING) & (jobs.priority
                                         > int(jobs.host["priority"][idx]))
    rows = torch.arange(J, dtype=torch.int32, device=jobs.device)
    order = torch.sort(torch.where(lower, -rows, INF_TIME), stable=True)[1]
    primary = torch.where(lower, -jobs.priority, INF_TIME)[order]
    order = order[torch.sort(primary, stable=True)[1]]
    nodes_o = torch.where(lower, jobs.nodes, 0)[order]
    cum = torch.cumsum(nodes_o, 0, dtype=torch.int32)
    take_rank = (cum - nodes_o < max(need, 0)) & (nodes_o > 0)
    victim = torch.zeros(J, dtype=torch.bool, device=jobs.device)
    victim[order] = take_rank
    freed = int(torch.sum(torch.where(victim, jobs.nodes, 0)))
    state.remaining = torch.where(
        victim, torch.clamp(state.finish - state.clock, min=1), state.remaining)
    state.jstate = torch.where(victim, WAITING, state.jstate).to(torch.int32)
    state.finish = torch.where(victim, INF_TIME, state.finish)
    state.rsv_finish = torch.where(victim, INF_TIME, state.rsv_finish)
    state.free += freed
    return state


def blocking_order(jobs: JobSet, policy: int) -> torch.Tensor:
    """The queue permutation of a blocking policy, stable by row: the
    (key, row) order its head walks, invariant for a whole run.  Backfill's
    blocking phase is FCFS, so it shares the FCFS permutation."""
    key = {FCFS: jobs.submit, SJF: jobs.estimate, LJF: -jobs.estimate,
           BACKFILL: jobs.submit}[policy]
    return torch.sort(key, stable=True)[1]


def _fast_order(jobs: JobSet, policy: int) -> Optional[torch.Tensor]:
    """The batched pass's permutation, or ``None`` for the per-start loop.

    As in the reference without dependency edges and without an allocation
    context: backfill takes the batched pass (one shadow walk per event in
    place of one per selection); FCFS, SJF and LJF batch only on
    dependency-carrying tables, which the port does not carry yet; BestFit
    and preempt never batch."""
    return blocking_order(jobs, policy) if policy == BACKFILL else None


def _batched_pass(jobs: JobSet, state: SimState,
                  order: torch.Tensor) -> SimState:
    """Start the whole feasible prefix of the waiting queue in one shot.

    The sequential pass walks the waiting jobs in ``order`` and starts each
    while it fits.  Node counts are >= 1, so the started set is exactly the
    longest ordered waiting prefix whose node sum stays <= free (DESIGN.md
    §14).  Starts in a prefix are independent of one another, so they are
    applied as one vectorised update; the host reads only the nodes taken.
    """
    w_sorted = (state.jstate == WAITING)[order]
    cum = torch.cumsum(torch.where(w_sorted, jobs.nodes[order], 0), 0,
                       dtype=torch.int32)
    started = torch.zeros_like(w_sorted)
    started[order] = (cum <= state.free) & w_sorted
    clock = state.clock
    state.jstate = torch.where(started, RUNNING, state.jstate).to(torch.int32)
    state.start = torch.where(started, torch.clamp(state.start, max=clock),
                              state.start)
    state.finish = torch.where(started, state.remaining + clock, state.finish)
    state.rsv_finish = torch.where(started, jobs.estimate + clock,
                                   state.rsv_finish)
    state.free -= int(torch.sum(torch.where(started, jobs.nodes, 0)))
    return state


def _batched_backfill_pass(jobs: JobSet, state: SimState,
                           order: torch.Tensor) -> SimState:
    """One whole EASY-backfill scheduling pass (DESIGN.md §18.2).

    Phase A: while the FCFS head fits, EASY starts it, which is the
    blocking batched pass over the submit order; it runs only when the head
    fits before it.  Phase B: once the head blocks (``free < head_need``),
    its shadow is walked ONCE.  The shadow time is invariant under the
    admissions that follow, and ``extra`` follows one rule: an admission
    whose release ``(max(clock + estimate, clock + 1), row)`` sorts after
    the reach entry ``(shadow, k_row)`` consumes its nodes.  An overdraw
    (a release tie at the shadow) moves the reach entry within its tie
    group, so the walk is made again (``_redo``, counted in ``counters``).
    Every candidate pick is one fused selection.
    """
    sel, nodes, estimate = (jobs.selector, jobs.host["nodes"],
                            jobs.host["estimate"])
    head, _ = sel.select(select_ref.HEAD_SUBMIT, state.jstate)
    if head >= 0 and int(nodes[head]) <= state.free:
        _batched_pass(jobs, state, order)
        head, _ = sel.select(select_ref.HEAD_SUBMIT, state.jstate)
    if head < 0:
        return state
    # necessary for any admission: some non-head waiting job fits now
    if sel.select(select_ref.ANY_FIT, state.jstate, cap=state.free,
                  exclude=head)[0] < 0:
        return state
    head_need = int(nodes[head])
    shadow, extra, k_row = policies.backfill_shadow(jobs, state, head_need)

    def pick() -> int:
        return sel.select(select_ref.BACKFILL_CAND, state.jstate,
                          clock=state.clock, free=state.free, cap=state.free,
                          shadow=shadow, extra=extra, exclude=head)[0]

    idx = pick()
    while idx >= 0:
        _start_job(jobs, state, idx)
        t_c = max(state.clock + int(estimate[idx]), state.clock + 1)
        if t_c > shadow or (t_c == shadow and idx > k_row):
            extra -= int(nodes[idx])
        if extra < 0:   # _redo: the shadow time stands, (extra, k_row) move
            _, extra, k_row = policies.backfill_shadow(jobs, state, head_need)
            counters["redo"] += 1
        idx = pick()
    return state


def _schedule_pass(policy: int, jobs: JobSet, state: SimState,
                   order: Optional[torch.Tensor] = None) -> SimState:
    """Start jobs until the policy blocks (Algorithm 1 lines 16-21): the
    batched backfill pass when ``_fast_order`` gave a permutation (it gives
    one for backfill only), else the per-start selector loop."""
    if order is not None:
        return _batched_backfill_pass(jobs, state, order)
    idx = policies.select(policy, jobs, state)
    while idx >= 0:
        if policy == PREEMPT and int(jobs.host["nodes"][idx]) > state.free:
            _preempt_for(jobs, state, idx)
        _start_job(jobs, state, idx)
        idx = policies.select(policy, jobs, state)
    return state


def _event_step(policy: int, jobs: JobSet, state: SimState,
                order: Optional[torch.Tensor] = None) -> int:
    """Process one event in place; returns the number of jobs it
    completed (the host's count of unfinished jobs drops by that much).
    ``order`` is ``_fast_order``'s permutation (``None``: selector loop)."""
    pending = state.jstate == PENDING
    running = state.jstate == RUNNING
    # min over arrivals and completions at once == min(t_arr, t_fin)
    nxt = torch.where(pending, jobs.submit,
                      torch.where(running, state.finish, INF_TIME))
    clock = torch.min(nxt)
    completed = running & (state.finish <= clock)
    freed = torch.sum(torch.where(completed, jobs.nodes, 0))
    jstate = torch.where(completed, DONE, state.jstate)
    arrived = (jstate == PENDING) & (jobs.submit <= clock)
    state.jstate = torch.where(arrived, WAITING, jstate).to(torch.int32)
    clock, freed, n_completed = torch.stack(
        [clock.to(torch.int64), freed, torch.sum(completed)]).tolist()
    state.clock = clock
    state.free += freed
    state.n_events += 1
    walks, redo = shadow_walk.launches, counters["redo"]
    _schedule_pass(policy, jobs, state, order)
    counters["max_walks_per_event"] = max(
        counters["max_walks_per_event"],
        shadow_walk.launches - walks - (counters["redo"] - redo))
    return n_completed


def policies_id(policy) -> int:
    if isinstance(policy, str):
        return POLICY_IDS[policy.lower()]
    return int(policy)


def simulate(jobs: JobSet, policy, total_nodes: int, *,
             max_events: Optional[int] = None, device=None) -> SimResult:
    """Run the whole simulation of one cluster in scalar-counter mode.

    ``device=None`` runs on ``cuda`` (and raises without one); the job
    table moves there if it lies elsewhere.  ``max_events`` caps the event
    count (default ``6 * capacity + 8``, as in the reference).
    """
    device = resolve_device(device)
    if jobs.device != device:
        jobs = jobs.to(device)
    policy = min(max(policies_id(policy), 0), len(policies.SELECTORS) - 1)
    cap = max_events if max_events is not None else 6 * jobs.capacity + 8
    state = SimState.init(jobs, total_nodes)
    order = _fast_order(jobs, policy)
    jobs.selector.bind_stream()
    unfinished = int(torch.sum(jobs.valid))
    while unfinished > 0 and state.n_events < cap:
        unfinished -= _event_step(policy, jobs, state, order)
    return result_from_state(jobs, state)
