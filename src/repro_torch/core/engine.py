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

Each pass is written once, as a generator of requests (``policies``'
module docstring).  A solo run (:func:`simulate`) answers them one at a
time; an ensemble (:func:`simulate_batch`, B members of a stacked ``[B,
J]`` table in lockstep) steps every member's event at once and, round by
round, answers each kind of request for all the members that made it with
one batched launch or one indexed write, so every member makes exactly the
calls of its solo run.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import policies
from repro_torch.core.jobs import (
    BACKFILL, DONE, FCFS, INF_TIME, JOB_FIELDS, LJF, PENDING, POLICY_IDS,
    PREEMPT, RUNNING, SJF, WAITING, EnsembleState, JobSet, SimResult,
    SimState, resolve_device, result_from_state,
)
from repro_torch.core.policies import (
    NO_PARAMS, PREFIX, RECLAIM, SELECT, START, SUSPEND, WALK,
)
from repro_torch.kernels.queue_select import ref as select_ref

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


def _backfill_pass(host, st):
    """One whole EASY-backfill scheduling pass (DESIGN.md §18.2), as a
    generator of requests (``policies``' module docstring).

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
    nodes, estimate = host["nodes"], host["estimate"]
    head, _ = yield (SELECT, select_ref.HEAD_SUBMIT, NO_PARAMS)
    if head >= 0 and int(nodes[head]) <= st.free:
        yield (PREFIX,)
        head, _ = yield (SELECT, select_ref.HEAD_SUBMIT, NO_PARAMS)
    if head < 0:
        return
    # necessary for any admission: some non-head waiting job fits now
    if (yield (SELECT, select_ref.ANY_FIT,
               select_ref.params(cap=st.free, exclude=head)))[0] < 0:
        return
    head_need = int(nodes[head])
    shadow, extra, k_row = yield policies.walk_request(st, head_need)

    def pick():
        return (SELECT, select_ref.BACKFILL_CAND, select_ref.params(
            clock=st.clock, free=st.free, cap=st.free, shadow=shadow,
            extra=extra, exclude=head))

    idx = (yield pick())[0]
    while idx >= 0:
        yield (START, idx)
        t_c = max(st.clock + int(estimate[idx]), st.clock + 1)
        if t_c > shadow or (t_c == shadow and idx > k_row):
            extra -= int(nodes[idx])
        if extra < 0:   # _redo: the shadow time stands, (extra, k_row) move
            _, extra, k_row = yield policies.walk_request(st, head_need,
                                                          redo=True)
        idx = (yield pick())[0]


def _loop_pass(policy: int, host, st):
    """The per-start selector loop (Algorithm 1 lines 16-21), as a
    generator of requests: start jobs until the policy blocks."""
    selector = policies.SELECTORS[policy]
    idx = yield from selector(host, st, st.free)
    while idx >= 0:
        if policy == PREEMPT and int(host["nodes"][idx]) > st.free:
            yield (SUSPEND, idx)
        yield (START, idx)
        idx = yield from selector(host, st, st.free)


def _pass(policy: int, host, st, batched: bool):
    """A member's scheduling pass: the batched backfill pass when
    ``_fast_order`` gives a permutation (backfill only), else the per-start
    selector loop."""
    return _backfill_pass(host, st) if batched else _loop_pass(policy, host,
                                                               st)


def _drive_solo(gen, jobs: JobSet, state: SimState,
                order: Optional[torch.Tensor]) -> int:
    """Answer a pass's requests one at a time on one table; returns the
    walks it made besides its redos."""
    walks = 0

    def respond(req):
        nonlocal walks
        kind = req[0]
        if kind is START:
            _start_job(jobs, state, req[1])
        elif kind is SUSPEND:
            _preempt_for(jobs, state, req[1])
        elif kind is PREFIX:
            _batched_pass(jobs, state, order)
        else:
            if kind is WALK:
                if req[2]:
                    counters["redo"] += 1
                else:
                    walks += 1
            return policies.answer(jobs, state, req)
        return None

    policies.drive(gen, respond)
    return walks


def _batched_backfill_pass(jobs: JobSet, state: SimState,
                           order: torch.Tensor) -> SimState:
    """The batched backfill pass (:func:`_backfill_pass`) on one table."""
    _drive_solo(_backfill_pass(jobs.host, state), jobs, state, order)
    return state


def _schedule_pass(policy: int, jobs: JobSet, state: SimState,
                   order: Optional[torch.Tensor] = None) -> SimState:
    """Start jobs until the policy blocks (Algorithm 1 lines 16-21): the
    batched backfill pass when ``_fast_order`` gave a permutation (it gives
    one for backfill only), else the per-start selector loop."""
    walks = _drive_solo(_pass(policy, jobs.host, state, order is not None),
                        jobs, state, order)
    counters["max_walks_per_event"] = max(counters["max_walks_per_event"],
                                          walks)
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
    _schedule_pass(policy, jobs, state, order)
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


# ---------------------------------------------------------------------------
# ensembles: B members in lockstep
# ---------------------------------------------------------------------------

def _event_step_batch(jobs: JobSet, state: EnsembleState,
                      active: Optional[torch.Tensor]) -> list:
    """:func:`_event_step`'s event for every member at once, over the
    ``[B, J]`` state, written in place.  ``active`` (bool[B], ``None`` for
    every member) masks the members that are done, whose state is left as
    it is.  One read: ``[clock, freed, n_completed]`` for each member (a
    done member's row means nothing)."""
    pending = state.jstate == PENDING
    running = state.jstate == RUNNING
    nxt = torch.where(pending, jobs.submit,
                      torch.where(running, state.finish, INF_TIME))
    clock = torch.amin(nxt, dim=1)
    completed = running & (state.finish <= clock[:, None])
    if active is not None:
        completed &= active[:, None]
    freed = torch.sum(torch.where(completed, jobs.nodes, 0), dim=1)
    jstate = torch.where(completed, DONE, state.jstate)
    arrived = (jstate == PENDING) & (jobs.submit <= clock[:, None])
    if active is not None:
        arrived &= active[:, None]
    state.jstate.copy_(torch.where(arrived, WAITING, jstate))
    return torch.stack([clock.to(torch.int64), freed,
                        torch.sum(completed, dim=1)], dim=1).tolist()


def _to_device(rows, device) -> torch.Tensor:
    """Host ints (a list of equal-length lists) as one int64 tensor on
    ``device``: one copy for all of a round's per-member scalars."""
    return torch.tensor(rows, dtype=torch.int64).to(device)


def _start_batch(jobs: JobSet, state: EnsembleState, hosts, reqs) -> None:
    """:func:`_start_job` for one job of each member in ``reqs`` (pairs of
    member and row): one indexed write a column for all of them."""
    ms = [b for b, _ in reqs]
    ix = [i for _, i in reqs]
    clk = [state.members[b].clock for b in ms]
    rsv = [c + int(hosts[b]["estimate"][i]) for b, i, c in zip(ms, ix, clk)]
    m, i, c, r = _to_device([ms, ix, clk, rsv], jobs.device).unbind(0)
    c = c.to(torch.int32)
    state.jstate[m, i] = RUNNING
    state.start[m, i] = torch.minimum(state.start[m, i], c)
    state.finish[m, i] = state.remaining[m, i] + c
    state.rsv_finish[m, i] = r.to(torch.int32)
    for b, idx in reqs:
        state.members[b].free -= int(hosts[b]["nodes"][idx])


def _prefix_batch(jobs: JobSet, state: EnsembleState, order: torch.Tensor,
                  ms) -> None:
    """:func:`_batched_pass` for the members ``ms``, along ``dim=1``;
    ``order`` is ``[B, J]``, each member's permutation in its row."""
    m, free, clk = _to_device(
        [ms, [state.members[b].free for b in ms],
         [state.members[b].clock for b in ms]], jobs.device).unbind(0)
    order, jst, nodes = order[m], state.jstate[m], jobs.nodes[m]
    w_sorted = torch.gather(jst == WAITING, 1, order)
    cum = torch.cumsum(torch.where(w_sorted, torch.gather(nodes, 1, order), 0),
                       1, dtype=torch.int32)
    started = torch.zeros_like(w_sorted).scatter_(
        1, order, (cum <= free[:, None]) & w_sorted)
    clk = clk[:, None].to(torch.int32)
    start, finish, rsv = state.start[m], state.finish[m], state.rsv_finish[m]
    state.jstate[m] = torch.where(started, RUNNING, jst).to(torch.int32)
    state.start[m] = torch.where(started, torch.minimum(start, clk), start)
    state.finish[m] = torch.where(started, state.remaining[m] + clk, finish)
    state.rsv_finish[m] = torch.where(started, jobs.estimate[m] + clk, rsv)
    taken = torch.sum(torch.where(started, nodes, 0), dim=1).tolist()
    for b, t in zip(ms, taken):
        state.members[b].free -= t


def _suspend_batch(jobs: JobSet, state: EnsembleState, hosts, reqs) -> None:
    """:func:`_preempt_for` for one head of each member in ``reqs`` (pairs
    of member and row), the two stable sorts along ``dim=1``."""
    ms = [b for b, _ in reqs]
    need = [int(hosts[b]["nodes"][i]) - state.members[b].free
            for b, i in reqs]
    prio = [int(hosts[b]["priority"][i]) for b, i in reqs]
    clk = [state.members[b].clock for b in ms]
    m, need, prio, clk = _to_device([ms, need, prio, clk],
                                    jobs.device).unbind(0)
    jst, pr, nodes = state.jstate[m], jobs.priority[m], jobs.nodes[m]
    lower = (jst == RUNNING) & (pr > prio[:, None])
    rows = torch.arange(jobs.capacity, dtype=torch.int32, device=jobs.device)
    order = torch.sort(torch.where(lower, -rows, INF_TIME), dim=1,
                       stable=True)[1]
    primary = torch.gather(torch.where(lower, -pr, INF_TIME), 1, order)
    order = torch.gather(order, 1, torch.sort(primary, dim=1, stable=True)[1])
    nodes_o = torch.gather(torch.where(lower, nodes, 0), 1, order)
    cum = torch.cumsum(nodes_o, 1, dtype=torch.int32)
    take_rank = ((cum - nodes_o < torch.clamp(need, min=0)[:, None])
                 & (nodes_o > 0))
    victim = torch.zeros_like(lower).scatter_(1, order, take_rank)
    freed = torch.sum(torch.where(victim, nodes, 0), dim=1).tolist()
    clk = clk[:, None].to(torch.int32)
    finish = state.finish[m]
    state.remaining[m] = torch.where(
        victim, torch.clamp(finish - clk, min=1), state.remaining[m])
    state.jstate[m] = torch.where(victim, WAITING, jst).to(torch.int32)
    state.finish[m] = torch.where(victim, INF_TIME, finish)
    state.rsv_finish[m] = torch.where(victim, INF_TIME, state.rsv_finish[m])
    for b, f in zip(ms, freed):
        state.members[b].free += f


def _reclaim_batch(jobs: JobSet, state: EnsembleState, reqs) -> list:
    """``policies.answer``'s RECLAIM for each ``(member, priority)``
    request: one reduction for all of them."""
    m, prio = _to_device([[b for b, _ in reqs], [p for _, p in reqs]],
                         jobs.device).unbind(0)
    lower = ((state.jstate[m] == RUNNING)
             & (jobs.priority[m] > prio[:, None]))
    return torch.sum(torch.where(lower, jobs.nodes[m], 0), dim=1).tolist()


def _schedule_batch(jobs: JobSet, state: EnsembleState, pols, hosts,
                    order, members) -> None:
    """Every member's scheduling pass of this event, in lockstep rounds.

    Each round sends every member still in its pass the answer to its last
    request and gathers its next one; then each kind of request is answered
    for all the members that made it at once: one batched launch for the
    selections, one for the walks, one indexed write or reduction for the
    rest.  Members touch only their own rows, so the order of the kinds
    within a round does not matter."""
    gens = {b: _pass(pols[b], hosts[b], state.members[b],
                     pols[b] == BACKFILL) for b in members}
    answers = dict.fromkeys(gens)
    walks = dict.fromkeys(gens, 0)
    sel = jobs.selector
    while gens:
        reqs = {SELECT: [], WALK: [], RECLAIM: [], START: [], SUSPEND: [],
                PREFIX: []}
        for b in list(gens):
            try:
                req = gens[b].send(answers[b])
            except StopIteration:
                del gens[b]
                continue
            reqs[req[0]].append((b, req))
            answers[b] = None
        if reqs[SELECT]:
            got = sel.select_batch([(b, r[1], r[2]) for b, r in reqs[SELECT]],
                                   state.jstate)
            for (b, _), a in zip(reqs[SELECT], got):
                answers[b] = a
        if reqs[WALK]:
            got = sel.walk_batch([(b, r[1]) for b, r in reqs[WALK]],
                                 state.jstate, state.rsv_finish)
            for (b, r), a in zip(reqs[WALK], got):
                answers[b] = a
                if r[2]:
                    counters["redo"] += 1
                else:
                    walks[b] += 1
        if reqs[RECLAIM]:
            got = _reclaim_batch(jobs, state,
                                 [(b, r[1]) for b, r in reqs[RECLAIM]])
            for (b, _), a in zip(reqs[RECLAIM], got):
                answers[b] = a
        if reqs[SUSPEND]:
            _suspend_batch(jobs, state, hosts,
                           [(b, r[1]) for b, r in reqs[SUSPEND]])
        if reqs[START]:
            _start_batch(jobs, state, hosts,
                         [(b, r[1]) for b, r in reqs[START]])
        if reqs[PREFIX]:
            _prefix_batch(jobs, state, order, [b for b, _ in reqs[PREFIX]])
    if walks:
        counters["max_walks_per_event"] = max(
            counters["max_walks_per_event"], max(walks.values()))


def simulate_batch(jobs: JobSet, policies_b, total_nodes_b, *,
                   max_events: Optional[int] = None) -> SimResult:
    """Run B members of a stacked table (``[B, J]`` columns) in lockstep.

    Member ``b`` runs policy ``policies_b[b]`` on ``total_nodes_b[b]``
    nodes, and its result equals :func:`simulate` of its own table bit for
    bit: an event step serves every member at once and every round of the
    scheduling passes answers each kind of request for every member with
    one launch (:func:`_schedule_batch`).  A member is done once it has no
    unfinished job or has reached its event cap; from then on its state is
    never written again ("max iterations across members, finished carries
    preserved", DESIGN.md §18.1).  Runs on the table's device."""
    B = jobs.batch
    if B is None:
        raise ValueError("simulate_batch needs a stacked [B, J] table")
    pols = [min(max(policies_id(p), 0), len(policies.SELECTORS) - 1)
            for p in policies_b]
    if len(pols) != B or len(total_nodes_b) != B:
        raise ValueError(f"{len(pols)} policies and {len(total_nodes_b)} "
                         f"node counts for {B} members")
    cap = max_events if max_events is not None else 6 * jobs.capacity + 8
    state = EnsembleState.init(jobs, total_nodes_b)
    # backfill's batched pass walks the FCFS permutation of its member
    order = (torch.sort(jobs.submit, dim=1, stable=True)[1]
             if BACKFILL in pols else None)
    host = jobs.host
    hosts = [{f: host[f][b] for f in JOB_FIELDS} for b in range(B)]
    jobs.selector.bind_stream()
    unfinished = torch.sum(jobs.valid, dim=1).tolist()
    members = [b for b in range(B) if unfinished[b] > 0 and cap > 0]
    active, n_masked = None, B
    while members:
        if len(members) != n_masked:   # a member is done: mask it from now
            mask = [False] * B
            for b in members:
                mask[b] = True
            active, n_masked = torch.tensor(mask).to(jobs.device), len(members)
        stepped = _event_step_batch(jobs, state, active)
        for b in members:
            clock, freed, n_completed = stepped[b]
            st = state.members[b]
            st.clock = clock
            st.free += freed
            st.n_events += 1
            unfinished[b] -= n_completed
        _schedule_batch(jobs, state, pols, hosts, order, members)
        members = [b for b in members
                   if unfinished[b] > 0 and state.members[b].n_events < cap]
    return result_from_state(jobs, state)
