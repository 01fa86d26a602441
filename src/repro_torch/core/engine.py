"""The discrete-event engine of the PyTorch port (scalar-counter mode).

Counterpart of ``repro.core.engine`` with ``machine``, ``failures``,
``service`` and ``malleable`` all ``None`` and no dependency edges.  Event
semantics are the reference's:

  1. advance the clock to min(next arrival, next completion),
  2. process every completion with finish <= clock (reclaim nodes),
  3. process every arrival with submit <= clock (enqueue),
  4. run the scheduling pass: ask the policy selector for a job and start
     it, until the selector returns -1.

PyTorch has no device-side while loop, so the host drives both loops.  The
per-job state stays on the device and is updated in place; the host keeps
the clock, the free-node counter and the event count, and reads one small
tensor per event (clock, freed nodes, completions) plus one ``(index,
score)`` pair per selection.  The scheduling pass is the reference's
per-start selector loop for every policy: the batched passes that the
reference's ``_fast_order`` picks for backfill (DESIGN.md §14/§18) are
bit-identical to that loop and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import policies
from repro_torch.core.jobs import (
    DONE, INF_TIME, PENDING, POLICY_IDS, PREEMPT, RUNNING, WAITING, JobSet,
    SimResult, SimState, resolve_device, result_from_state,
)


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


def _schedule_pass(policy: int, jobs: JobSet, state: SimState) -> SimState:
    """Start jobs until the policy blocks (Algorithm 1 lines 16-21)."""
    idx = policies.select(policy, jobs, state)
    while idx >= 0:
        if policy == PREEMPT and int(jobs.host["nodes"][idx]) > state.free:
            _preempt_for(jobs, state, idx)
        _start_job(jobs, state, idx)
        idx = policies.select(policy, jobs, state)
    return state


def _event_step(policy: int, jobs: JobSet, state: SimState) -> int:
    """Process one event in place; returns the number of jobs it
    completed (the host's count of unfinished jobs drops by that much)."""
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
    _schedule_pass(policy, jobs, state)
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
    unfinished = int(torch.sum(jobs.valid))
    while unfinished > 0 and state.n_events < cap:
        unfinished -= _event_step(policy, jobs, state)
    return result_from_state(jobs, state)
