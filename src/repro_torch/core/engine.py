"""The discrete-event engine of the PyTorch port.

Counterpart of ``repro.core.engine``, in scalar-counter mode or with a
machine (topology-aware allocation), on tables with or without dependency
edges, with or without a failure stream (``failures``), a service plan
(``service``) and a malleable plan (``malleable``).  Event semantics are
the reference's:

  1. advance the clock to min(next arrival, next completion, next stream
     entry),
  2. process every completion with finish <= clock (reclaim nodes),
  3. consume the failure/repair entries, then the autoscaler ticks, then
     the resize ticks, with time <= clock (while some job is not DONE),
  4. process every arrival with submit <= clock (enqueue),
  5. run the scheduling pass: start jobs until the policy blocks.

With dependency edges (paper §3, DESIGN.md §13-§14) a PENDING job arrives
only once ``submit <= clock`` and its unmet-dependency counter
``n_unmet`` is 0; an unreleased job does not set the clock.  Completions
decrement the counters along their out-edges (one scatter-add over the
edge list, :func:`dep_list`, which holds in any edge order), so a job
whose last dependency finished arrives in the same event.

Stream entries (DESIGN.md §15-§16) are known before the run, so their
streams stay on the host (``reliability.FailCtx``, ``serving.SvcCtx``) and
the next entry's time bounds the device's clock as a scalar.  A failure
kills the job on its node (on a machine, the node's owner; in scalar mode
the job whose running-node cumsum covers the slot ``node % (free +
busy)``), which requeues at its submit rank with the work since its last
checkpoint re-charged, or aborts and releases its dependents; a failure
costs one read, a repair none.  A tick reads the queued demand once and
moves nodes in or out of service.  On a machine, down and offline nodes
are painted busy, owned by nobody (the out-of-range id ``J``), in every
placement, cap and log (:func:`_owner_eff`); releases read the true map.
Arrivals come after the event's one read and after the stream entries,
with or without a stream.

Malleable jobs (DESIGN.md §17): a job's node footprint is its current
width (``SimState.mal``), on the device for the kernel and the reductions
and mirrored on the host for the passes.  A dispatch picks, among the
widths up to the placeable size, the first with the least dilated runtime
from the plan's host table, so the choice costs no read; completions free
the width and close the node-second segment.  In elastic mode the resize
ticks are a third stream: each tick reads the queued demand and the
widest and narrowest running jobs with their finishes in one read, and
shrinks or grows one of them; a failure that hits a job wider than
``min_width`` sheds the failed node instead of killing it.  A resize
re-dilates the remaining wall time in float32 on the host
(:func:`_ratio_ceil`).  Malleable runs keep the per-start selector loop.

PyTorch has no device-side while loop, so the host drives both loops.  The
per-job state stays on the device and is updated in place; the host keeps
the clock, the free-node counter and the event count, and reads one small
tensor per event (clock, freed nodes, completions) plus one ``(index,
score)`` pair per selection.  The scheduling pass is the reference's
(``_fast_order`` picks, as ``repro.api.run`` does): for backfill the
batched pass ``_batched_backfill_pass`` (one shadow walk per event,
DESIGN.md §18); for FCFS, SJF and LJF on a table with edges the blocking
prefix pass ``_batched_pass``, which makes no selection; else the
per-start selector loop.  All paths are bit-identical.

Each pass is written once, as a generator of requests (``policies``'
module docstring).  A solo run (:func:`simulate`) answers them one at a
time; an ensemble (:func:`simulate_batch`, B members of a stacked ``[B,
J]`` table in lockstep) steps every member's event at once and, round by
round, answers each kind of request for all the members that made it with
one batched launch or one indexed write, so every member makes exactly the
calls of its solo run.

A conservative window (:func:`simulate_window`; over a stack in lockstep,
:func:`simulate_window_batch`, the multicluster engine's step) runs the
same events up to a bound ``t_hi``, on a state carried across calls: an
event past the bound changes nothing, which the host learns from the
event's one read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import alloc as _alloc
from repro_torch.core import policies
from repro_torch.core.jobs import (
    BACKFILL, DONE, FCFS, INF_TIME, LJF, PENDING, POLICY_IDS,
    PREEMPT, RUNNING, SJF, WAITING, DepList, EnsembleState, JobSet,
    SimResult, SimState, count_deps, edge_list, resolve_device,
    result_from_state,
)
from repro_torch.core.policies import (
    NO_PARAMS, PREFIX, RECLAIM, SELECT, START, SUSPEND, WALK,
)
from repro_torch.kernels.queue_select import ref as select_ref
from repro_torch.malleable.model import make_mal_ctx
from repro_torch.reliability.model import FAIL, REQUEUE, make_fail_ctx
from repro_torch.serving.model import make_svc_ctx

# Counts for the on-card checks: the batched backfill pass's shadow-walk
# recomputations after an overdraw of ``extra`` (``redo``), the most walk
# launches one event made besides those (``max_walks_per_event``), and the
# reads of the largest free run that starts cost under ``contiguous``
# (``cap_reads``, one a start; an ensemble's round reads once for all its
# members' starts).  The stream entries consumed (``failures``,
# ``repairs``, ``ticks``), the kills by kind (``requeues``, ``aborts``) and
# the device reads the streams cost (``stream_reads``: one a failure, one
# an event with ticks, and one refresh of the largest free run after the
# entries of an event that moved the map under ``contiguous``).  Malleable
# runs count the resize ticks consumed (``resize_ticks``), their device
# reads (``resize_reads``: one a tick that may resize; a tick after one
# that did nothing in the same event costs none) and the resizes made
# (``resizes``: grows and shrinks at ticks, and failure shrinks).
COUNTER_KEYS = ("redo", "max_walks_per_event", "cap_reads", "failures",
                "repairs", "ticks", "requeues", "aborts", "stream_reads",
                "resize_ticks", "resize_reads", "resizes")
counters = dict.fromkeys(COUNTER_KEYS, 0)


def reset_counters() -> None:
    counters.update(dict.fromkeys(COUNTER_KEYS, 0))


# Strategies whose placement cap IS the free counter and which take the
# batched passes; ``contiguous`` (largest-free-run cap) and ``topo`` keep
# the per-start loop, as in the reference (DESIGN.md §14).
_COUNT_CAPPED = (_alloc.SIMPLE, _alloc.SPREAD)
# the blocking head-of-queue policies, which take the prefix pass on a
# table with edges
_BLOCKING = (FCFS, SJF, LJF)


class AllocCtx(NamedTuple):
    """A run's allocation context: the machine, the strategy id and the
    contention model (host values)."""

    machine: _alloc.Machine
    strategy: int
    contention: _alloc.Contention


def make_alloc_ctx(machine, strategy, contention,
                   total_nodes=None) -> Optional[AllocCtx]:
    """Canonicalize the allocation arguments, or ``None`` for
    scalar-counter mode.  ``alloc``/``contention`` without a ``machine``
    raise (they would be ignored), and so does a ``total_nodes`` that
    disagrees with the machine (it would corrupt the occupancy map)."""
    if machine is None:
        if strategy is not None or contention is not None:
            raise ValueError(
                "alloc/contention require machine=; without a Machine the "
                "simulation runs in scalar-counter mode and would silently "
                "ignore them")
        return None
    if total_nodes is not None and int(total_nodes) != machine.n_nodes:
        raise ValueError(f"machine has {machine.n_nodes} nodes but "
                         f"total_nodes={int(total_nodes)}")
    sid = _alloc.canonical_id(strategy)
    if isinstance(sid, list):
        raise ValueError("one run takes one allocation strategy; sweep "
                         "strategies with simulate_ensemble or sweep")
    return AllocCtx(machine, sid, _alloc.Contention.canonical(contention))


def _release_nodes(owner: torch.Tensor, released: torch.Tensor) -> None:
    """Free, in place, every node whose owning job row is set in
    ``released`` (``[..., N]`` maps against ``[..., J]`` masks).  ``owner``
    is the true map, which never holds the painted id ``J``."""
    J = released.shape[-1]
    hit = (owner >= 0) & torch.gather(released, -1,
                                      owner.clamp(0, J - 1).long())
    owner.masked_fill_(hit, -1)


def _owner_eff(state, m=None) -> torch.Tensor:
    """The occupancy map as placements, caps and the log see it (the
    reference's ``_owner_eff``): offline and down nodes painted with the
    out-of-range id ``J``, "busy, owned by nobody", so every free test
    excludes them.  ``m`` (device indices) takes those members' rows of an
    ensemble's map.  The true map is returned as it is without a painted
    mask."""
    own = state.node_owner if m is None else state.node_owner[m]
    J = state.jstate.shape[-1]
    for mask in (None if state.svc is None else state.svc.offline,
                 None if state.rel is None else state.rel.down):
        if mask is not None and mask.shape[-1]:
            own = torch.where(mask if m is None else mask[m], J, own)
    return own


class _MapLog:
    """The ``ev_lfb`` column of the event log, filled in blocks.

    The largest free run is a reduction of a few operations over the map;
    taking it at every event would cost more than the event's other
    allocation work.  So each event copies the map into a ring of
    :attr:`SIZE` snapshots (one operation), and one reduction a full ring
    writes the block of consecutive slots it covers.  An ensemble's map is
    ``[B, N]``: a member's slot of round ``r`` is ``r`` while it is active,
    and the slots past a member's event count keep their 0."""

    SIZE = 128

    def __init__(self, owner: torch.Tensor, ev_lfb: torch.Tensor):
        self.ring = torch.empty((self.SIZE, *owner.shape), dtype=owner.dtype,
                                device=owner.device)
        self.ev_lfb, self.n, self.first = ev_lfb, 0, 0

    def add(self, owner: torch.Tensor, slot: int, n_events=None) -> None:
        if self.n == 0:
            self.first = slot
        self.ring[self.n].copy_(owner)
        self.n += 1
        if self.n == self.SIZE:
            self.flush(n_events)

    def flush(self, n_events=None) -> None:
        """Write the ring's slots (``n_events``: each member's event count,
        for an ensemble)."""
        if self.n == 0:
            return
        lfb = _alloc.largest_free_run(self.ring[:self.n])
        block = slice(self.first, self.first + self.n)
        if n_events is None:
            self.ev_lfb[block] = lfb
        else:
            rows = torch.arange(self.first, self.first + self.n,
                                device=lfb.device)
            n_ev = torch.tensor(n_events).to(lfb.device)
            self.ev_lfb[:, block] = torch.where(
                rows[None, :] < n_ev[:, None], lfb.T, self.ev_lfb[:, block])
        self.n = 0


def _ratio_ceil(r: int, dur_new: int, dur_old: int) -> int:
    """``max(1, ceil(r * dur_new / dur_old))``, the re-dilation of a
    remaining wall time to a new width: float32, in the reference's order
    ``(r * dur_new) / dur_old`` (numpy float32 scalars on the host)."""
    v = (np.float32(r) * np.float32(dur_new)) / np.float32(dur_old)
    return max(int(np.ceil(v)), 1)


def _redilate(c, idx: int, rem: int, w_old: int, w_new: int) -> int:
    """Job ``idx``'s remaining wall time ``rem`` at ``w_old`` nodes,
    re-dilated to ``w_new`` by :func:`_ratio_ceil` over the plan's
    runtime table, each width clamped into the plan's range."""
    dur, lo, top = c.dur[idx], c.min_width, c.n_widths - 1
    return _ratio_ceil(rem, int(dur[min(max(w_new - lo, 0), top)]),
                       int(dur[min(max(w_old - lo, 0), top)]))


def _mal_dispatch(m, k: int, row, idx: int, cap: int) -> tuple:
    """Member ``k``'s moldable width choice for job ``idx`` with ``cap``
    nodes placeable: among the widths ``<= cap`` the first with the least
    dilated runtime (ties to the narrowest).  A fresh job runs ``dur[idx,
    k]``; a job requeued by a failure re-dilates the remaining time its
    kill charged from its width then.  Host arithmetic only; writes the
    host columns and returns ``(width, wall time)``."""
    c = m.ctx[k]
    dur = c.dur[idx]
    W, wlo = dur.shape[0], c.min_width
    fits = np.arange(wlo, wlo + W) <= cap
    kk = int(np.argmin(np.where(fits, dur, INF_TIME)))
    prev, w = int(row(m.prev_w)[idx]), wlo + kk
    if prev == 0:
        wall = int(dur[kk])
    else:
        wall = _redilate(c, idx, int(row(m.requeued)[idx]), prev, w)
    row(m.width_host)[idx] = row(m.prev_w)[idx] = w
    row(m.disp_dur)[idx] = dur[kk]
    return w, wall


def _start_job(jobs: JobSet, state: SimState, idx: int,
               ctx: Optional[AllocCtx] = None) -> SimState:
    """Start job ``idx`` now: schedule its completion from its remaining
    runtime, and record only its FIRST start time (and, with a failure
    stream, this start as its checkpoint base).  With an allocation
    context the strategy places its nodes on the painted map
    (:func:`_owner_eff`), the fingerprint is recorded and contention
    dilates the remaining runtime by the span.  A malleable job first
    chooses its width (:func:`_mal_dispatch`) and runs the wall time that
    width gives."""
    clock = state.clock
    m = state.mal
    if m is None:
        need = int(jobs.host["nodes"][idx])
    else:
        need, wall = _mal_dispatch(m, 0, _solo_row, idx,
                                   policies.placeable(state))
        m.width[idx] = need
        m.seg_start[idx] = clock
    state.jstate[idx] = RUNNING
    state.start[idx : idx + 1].clamp_(max=clock)
    if state.rel is not None:
        state.rel.last_start[idx] = clock
    if ctx is None:
        if m is None:
            state.finish[idx : idx + 1] = (state.remaining[idx : idx + 1]
                                           + clock)
        else:
            state.finish[idx] = clock + wall
    else:
        mask = _alloc.place(ctx.strategy, ctx.machine, _owner_eff(state),
                            need)
        span = _alloc.group_span(ctx.machine, mask)
        first, asum = _alloc.alloc_fingerprint(mask)
        state.node_owner.masked_fill_(mask, idx)
        state.alloc[:, idx] = torch.stack([first, span, asum])
        if m is None:
            state.finish[idx] = _alloc.dilate(
                ctx.contention, state.remaining[idx], span) + clock
        else:
            state.finish[idx] = clock + wall
        if state.lfb is not None:
            state.lfb = int(_alloc.largest_free_run(_owner_eff(state)))
            counters["cap_reads"] += 1
    state.rsv_finish[idx] = clock + int(jobs.host["estimate"][idx])
    state.free -= need
    return state


def _preempt_for(jobs: JobSet, state: SimState, idx: int,
                 ctx: Optional[AllocCtx] = None) -> SimState:
    """Suspend the minimal set of strictly-lower-priority running jobs so
    that job ``idx`` fits.  Victims go most-preemptible-first, (priority
    desc, row desc): two stable sorts, the secondary key first.  Suspended
    jobs keep their elapsed work (already dilated) and return to WAITING;
    with a machine they free their nodes.  The reclaim test counts nodes,
    so under ``contiguous`` the placement that follows may fall back to
    ``simple``."""
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
    if ctx is not None:
        _release_nodes(state.node_owner, victim)
    return state


def blocking_order(jobs: JobSet, policy: int) -> torch.Tensor:
    """The queue permutation of a blocking policy, stable by row: the
    (key, row) order its head walks, invariant for a whole run.  Backfill's
    blocking phase is FCFS, so it shares the FCFS permutation."""
    key = {FCFS: jobs.submit, SJF: jobs.estimate, LJF: -jobs.estimate,
           BACKFILL: jobs.submit}[policy]
    return torch.sort(key, stable=True)[1]


def _batches(policy: int, strategy: Optional[int], has_edges: bool,
             malleable: bool = False) -> bool:
    """Whether a member's pass is a batched one: under the free counter's
    cap (scalar mode, ``simple``, ``spread``), backfill always, and FCFS,
    SJF and LJF on a table with edges; a malleable run never (the batched
    passes assume rigid node requests)."""
    return not malleable and (strategy is None
                              or strategy in _COUNT_CAPPED) and (
        policy == BACKFILL or (has_edges and policy in _BLOCKING))


def _fast_order(jobs: JobSet, policy: int, strategy: Optional[int] = None,
                malleable: bool = False) -> Optional[torch.Tensor]:
    """The batched pass's permutation, or ``None`` for the per-start loop.

    As in the reference: backfill takes the batched pass (one shadow walk
    per event in place of one per selection) in scalar mode and under the
    count-capped strategies; FCFS, SJF and LJF take the blocking prefix
    pass there on tables with edges, whose events start whole release
    waves (the per-start loop elsewhere, where an event starts 0-1 jobs);
    BestFit, preempt and every malleable run never batch."""
    return (blocking_order(jobs, policy)
            if _batches(policy, strategy, jobs.dep_dst is not None, malleable)
            else None)


def _batched_pass(jobs: JobSet, state: SimState, order: torch.Tensor,
                  ctx: Optional[AllocCtx] = None) -> SimState:
    """Start the whole feasible prefix of the waiting queue in one shot.

    The sequential pass walks the waiting jobs in ``order`` and starts each
    while it fits.  Node counts are >= 1, so the started set is exactly the
    longest ordered waiting prefix whose node sum stays <= free (DESIGN.md
    §14).  In scalar mode starts in a prefix are independent of one
    another, so they are applied as one vectorised update; the host reads
    only the nodes taken.  With a machine each start places nodes on the
    map the previous one left, so the host reads the started rows and
    starts them one at a time, in key order, as the reference does.
    """
    w_sorted = (state.jstate == WAITING)[order]
    cum = torch.cumsum(torch.where(w_sorted, jobs.nodes[order], 0), 0,
                       dtype=torch.int32)
    if ctx is not None:
        for idx in order[(cum <= state.free) & w_sorted].tolist():
            _start_job(jobs, state, idx, ctx)
        return state
    started = torch.zeros_like(w_sorted)
    started[order] = (cum <= state.free) & w_sorted
    clock = state.clock
    state.jstate = torch.where(started, RUNNING, state.jstate).to(torch.int32)
    state.start = torch.where(started, torch.clamp(state.start, max=clock),
                              state.start)
    state.finish = torch.where(started, state.remaining + clock, state.finish)
    state.rsv_finish = torch.where(started, jobs.estimate + clock,
                                   state.rsv_finish)
    if state.rel is not None:
        state.rel.last_start.copy_(torch.where(started, clock,
                                               state.rel.last_start))
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
    generator of requests: start jobs until the policy blocks.  Each
    selection is capped by the strategy's placeable size
    (``policies.placeable``)."""
    selector = policies.SELECTORS[policy]
    idx = yield from selector(host, st, policies.placeable(st))
    while idx >= 0:
        if policy == PREEMPT and int(host["nodes"][idx]) > st.free:
            yield (SUSPEND, idx)
        yield (START, idx)
        idx = yield from selector(host, st, policies.placeable(st))


def _prefix_pass(host, st):
    """The blocking prefix pass of FCFS, SJF and LJF on a table with edges:
    one request, answered by :func:`_batched_pass`; no selection."""
    yield (PREFIX,)


def _pass(policy: int, host, st, batched: bool):
    """A member's scheduling pass: when ``_fast_order`` gives a
    permutation (``_batches``), the batched backfill pass or the blocking
    prefix pass; else the per-start selector loop."""
    if not batched:
        return _loop_pass(policy, host, st)
    return _backfill_pass(host, st) if policy == BACKFILL else _prefix_pass(
        host, st)


def _drive_solo(gen, jobs: JobSet, state: SimState,
                order: Optional[torch.Tensor],
                ctx: Optional[AllocCtx] = None) -> int:
    """Answer a pass's requests one at a time on one table; returns the
    walks it made besides its redos."""
    walks = 0

    def respond(req):
        nonlocal walks
        kind = req[0]
        if kind is START:
            _start_job(jobs, state, req[1], ctx)
        elif kind is SUSPEND:
            _preempt_for(jobs, state, req[1], ctx)
        elif kind is PREFIX:
            _batched_pass(jobs, state, order, ctx)
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
                           order: torch.Tensor,
                           ctx: Optional[AllocCtx] = None) -> SimState:
    """The batched backfill pass (:func:`_backfill_pass`) on one table."""
    _drive_solo(_backfill_pass(policies.host_columns(jobs, state), state),
                jobs, state, order, ctx)
    return state


def _schedule_pass(policy: int, jobs: JobSet, state: SimState,
                   order: Optional[torch.Tensor] = None,
                   ctx: Optional[AllocCtx] = None) -> SimState:
    """Start jobs until the policy blocks (Algorithm 1 lines 16-21): a
    batched pass when ``_fast_order`` gave a permutation, else the
    per-start selector loop."""
    walks = _drive_solo(_pass(policy, policies.host_columns(jobs, state),
                              state, order is not None),
                        jobs, state, order, ctx)
    counters["max_walks_per_event"] = max(counters["max_walks_per_event"],
                                          walks)
    return state


def dep_list(jobs: JobSet) -> Optional[DepList]:
    """The release structure of the table's edge list (``jobs.edge_list``),
    once a run or a window call, or ``None`` without edges."""
    if jobs.dep_dst is None:
        return None
    return edge_list(jobs.dep_dst, jobs.dep_src, jobs.capacity)


def _stream_time(state, k: int) -> int:
    """The time of member ``k``'s next stream entry (the earliest of its
    next failure/repair, its next autoscaler tick and its next resize
    tick), ``INF_TIME`` when all are drained: a host scalar that bounds
    the event's clock."""
    t = INF_TIME
    if state.rel is not None:
        f, p = state.rel.ctx[k], state.rel.ptr[k]
        if p < f.time.shape[0]:
            t = min(t, int(f.time[p]))
    if state.svc is not None:
        c, p = state.svc.ctx[k], state.svc.ptr[k]
        if p < c.tick_time.shape[0]:
            t = min(t, int(c.tick_time[p]))
    if state.mal is not None:
        c, p = state.mal.ctx[k], state.mal.ptr[k]
        if p < c.tick_time.shape[0]:
            t = min(t, int(c.tick_time[p]))
    return t


def _kill(jobs: JobSet, state, st, k: int, row, host, victim: int,
          fin_v: int, last_v: int, machine: bool) -> int:
    """Kill member ``k``'s job ``victim`` (its finish ``fin_v`` and latest
    start ``last_v`` read with the failure) in place; returns 1 when it
    aborted (it is DONE now), else 0.

    Requeue: WAITING at its submit rank, its remaining runtime re-charged
    by the work since its last checkpoint (all of it without checkpoints)
    plus the restart overhead.  Abort: DONE at the kill time, the elapsed
    work lost, and its dependents decremented along ``dep_src == victim``
    through a ``J + 1`` buffer whose last slot takes the pad edges.  Either
    way the victim's nodes are freed (on a machine, in the true map): in a
    malleable run its width (``host["nodes"]``), whose node-second segment
    closes, and a requeued victim waits at ``min_width`` again, its
    remaining time kept on the host for its redispatch."""
    rel, f, clock = state.rel, state.rel.ctx[k], st.clock
    m, w_v = state.mal, int(host["nodes"][victim])
    el = clock - last_v
    ckpt = f.checkpoint_interval
    lost = el - ((el // ckpt) * ckpt if ckpt > 0 else 0)
    v = slice(victim, victim + 1)
    row(state.rsv_finish)[v] = INF_TIME
    if m is not None:
        node_s = row(m.node_s)
        node_s[v] += w_v * (clock - row(m.seg_start)[v])
    if f.requeue == REQUEUE:
        rem = max(fin_v - clock + lost + f.restart_overhead, 1)
        row(state.jstate)[v] = WAITING
        row(state.finish)[v] = INF_TIME
        row(state.remaining)[v] = rem
        if m is not None:
            wlo = m.ctx[k].min_width
            row(m.requeued)[victim] = rem
            row(m.width_host)[victim] = wlo
            row(m.width)[v] = wlo
        row(rel.n_restarts)[v] += 1
        row(rel.lost_work)[v] += lost + f.restart_overhead
        counters["requeues"] += 1
        aborted = 0
    else:
        row(state.jstate)[v] = DONE
        row(state.finish)[v] = clock
        row(rel.lost_work)[v] += el
        row(rel.aborted)[v] = True
        if state.n_unmet is not None:
            J = jobs.capacity
            hit = (row(jobs.dep_src) == victim).to(torch.int32)
            dec = torch.zeros(J + 1, dtype=torch.int32, device=hit.device)
            dec.scatter_add_(0, row(jobs.dep_dst).long(), hit)
            row(state.n_unmet).sub_(dec[:J])
        counters["aborts"] += 1
        aborted = 1
    st.free += w_v
    if machine:
        own = row(state.node_owner)
        own.masked_fill_(own == victim, -1)
    return aborted


def _refingerprint(state, row, machine, victim: int) -> None:
    """Recompute job ``victim``'s allocation fingerprint from the nodes it
    owns now (after a resize)."""
    mask = row(state.node_owner) == victim
    first, asum = _alloc.alloc_fingerprint(mask)
    row(state.alloc)[:, victim] = torch.stack(
        [first, _alloc.group_span(machine, mask), asum])


def _mal_resize(m, row, victim: int, w_old: int, w_new: int,
                clock: int) -> None:
    """The ledger of a resize of ``victim`` from ``w_old`` to ``w_new``
    nodes at ``clock``: close its width segment, open the next, and write
    the width on the device and the host."""
    v = slice(victim, victim + 1)
    node_s = row(m.node_s)
    node_s[v] += w_old * (clock - row(m.seg_start)[v])
    row(m.seg_start)[v] = clock
    row(m.width)[v] = w_new
    row(m.width_host)[victim] = row(m.prev_w)[victim] = w_new
    row(m.n_resizes)[victim] += 1
    counters["resizes"] += 1


def _fail_shrink(state, st, k: int, row, victim: int, fin_v: int,
                 node: int, place) -> None:
    """An elastic job hit by a failure sheds the failed node instead of
    dying: its remaining wall time re-dilates to one node fewer and its
    finish moves; the shed node is down, so the free counter nets zero.
    On a machine the failed node itself leaves the job's allocation."""
    m, clock = state.mal, st.clock
    w_v = int(row(m.width_host)[victim])
    row(state.finish)[victim] = clock + _redilate(
        m.ctx[k], victim, fin_v - clock, w_v, w_v - 1)
    st.free += 1
    if place is not None:
        row(state.node_owner)[node] = -1
        _refingerprint(state, row, place[0], victim)
    _mal_resize(m, row, victim, w_v, w_v - 1, clock)


def _rel_entries(jobs: JobSet, state, st, k: int, row, host,
                 place) -> tuple:
    """Consume member ``k``'s failure/repair entries with time <= clock,
    one at a time (a kill changes the running set the next victim rule
    reads): ``(aborts, whether the map's painted mask moved)``.

    On a machine a failure takes its node down (the host keeps a copy of
    the mask, so a repair needs no read) and kills the node's owner, read
    with its finish and latest start in one read.  In scalar mode nodes
    are anonymous: with ``busy`` running nodes, the slot ``node % max(free
    + busy, 1)`` hits a job when it is below ``busy``, and the victim is
    the first row whose running-node cumsum exceeds the slot (the count of
    rows whose cumsum does not, the cumsum being nondecreasing); slot,
    victim, finish and latest start come back in one read.  ``row`` maps a
    ``[B, ...]`` tensor to member ``k``'s row (the identity in a solo
    run); ``place`` is ``(machine, strategy)`` on a machine, else
    ``None``.  Under an elastic malleable plan a victim wider than
    ``min_width`` sheds the node (:func:`_fail_shrink`) instead of
    dying."""
    rel = state.rel
    f = rel.ctx[k]
    K, p = f.time.shape[0], rel.ptr[k]
    aborts, moved = 0, False
    J = jobs.capacity
    machine = place is not None
    m = state.mal
    shrink_above = (m.ctx[k].min_width if m is not None and m.ctx[k].elastic
                    else None)
    jst, fin, last = row(state.jstate), row(state.finish), row(
        rel.last_start)
    while p < K and int(f.time[p]) <= st.clock:
        node, fail = int(f.node[p]), int(f.kind[p]) == FAIL
        p += 1
        counters["failures" if fail else "repairs"] += 1
        got = None
        if machine:
            down_h = row(rel.down_host)
            if bool(down_h[node]) == fail:   # a no-op of a hand-built stream
                continue
            down_h[node] = fail
            row(rel.down)[node] = fail
            moved = True
            if not fail:
                st.free += 1
                continue
            st.free -= 1
            own = row(state.node_owner)[node]
            vc = own.clamp(min=0).long()
            got = torch.stack([own, fin[vc], last[vc]]).tolist()
        else:
            if not fail:
                st.free += 1
                continue
            cum = torch.cumsum(torch.where(
                jst == RUNNING, row(policies.node_column(jobs, state)), 0),
                0, dtype=torch.int32)
            busy = cum[-1]
            slot = node % torch.clamp(busy + st.free, min=1)
            vc = torch.sum(cum <= slot).clamp(max=J - 1)
            hit, *got = torch.stack([busy - slot, vc.to(torch.int32),
                                     fin[vc], last[vc]]).tolist()
            got = got if hit > 0 else None
            st.free -= 1
        counters["stream_reads"] += 1
        if got is None or got[0] < 0:
            continue
        if shrink_above is not None and host["nodes"][got[0]] > shrink_above:
            _fail_shrink(state, st, k, row, got[0], got[1], node, place)
        else:
            aborts += _kill(jobs, state, st, k, row, host, *got, machine)
    rel.ptr[k] = p
    return aborts, moved


def _tick_entries(jobs: JobSet, state, st, k: int, row,
                  machine: bool) -> bool:
    """Consume member ``k``'s autoscaler ticks with time <= clock; returns
    whether the offline mask moved.

    The queued demand (nodes of the WAITING jobs, before this event's
    arrivals) is read once: ticks do not change it.  At ``demand >=
    up_threshold`` up to ``step`` nodes come back (never past
    ``max_nodes``; on a machine the lowest-index offline ones), else at
    ``demand <= down_threshold`` up to ``step`` free nodes leave (never
    below ``min_nodes``, never more than ``free``; on a machine the
    highest-index free online ones).  The online count after each tick
    goes to ``cap_online``.  In scalar mode a tick only moves ``free``."""
    svc = state.svc
    c = svc.ctx[k]
    T, p = c.tick_time.shape[0], svc.ptr[k]
    if p >= T or int(c.tick_time[p]) > st.clock:
        return False
    demand = int(torch.sum(torch.where(
        row(state.jstate) == WAITING,
        row(policies.node_column(jobs, state)), 0)))
    counters["stream_reads"] += 1
    moved = False
    while p < T and int(c.tick_time[p]) <= st.clock:
        n_on = svc.n_online[k]
        k_up = k_down = 0
        if demand >= c.up_threshold:
            k_up = min(max(c.max_nodes - n_on, 0), c.step)
        elif demand <= c.down_threshold:
            k_down = min(max(n_on - c.min_nodes, 0), c.step, max(st.free, 0))
        if machine and (k_up or k_down):
            off = row(svc.offline)
            if k_up:
                off &= torch.cumsum(off, 0, dtype=torch.int32) > k_up
            else:
                cand = (row(state.node_owner) < 0) & ~off
                rank = torch.cumsum(cand.flip(0), 0, dtype=torch.int32).flip(0)
                off |= cand & (rank <= k_down)
            moved = True
        n_on += k_up - k_down
        svc.n_online[k] = n_on
        row(svc.cap_online)[p] = n_on
        st.free += k_up - k_down
        p += 1
        counters["ticks"] += 1
    svc.ptr[k] = p
    return moved


def _resize_entries(jobs: JobSet, state, st, k: int, row, place) -> bool:
    """Consume member ``k``'s elastic resize ticks with time <= clock, one
    at a time (a resize changes the widths the next tick reads); returns
    whether the map moved.

    One read a tick: the queued demand (the widths of the WAITING jobs,
    before this event's arrivals), the widest running job above
    ``min_width`` and the narrowest below ``max_width`` (ties to the lowest
    row) with their finishes, and, where it is the cap, the largest free
    run.  At ``demand >= shrink_threshold`` the widest sheds ``min(step,
    width - min_width)`` nodes (on a machine its highest-index ones), else
    at ``demand <= grow_threshold`` the narrowest grows by ``min(step,
    max_width - width, cap)`` (on a machine placed by the strategy over
    the painted map).  A resize re-dilates the job's remaining wall time
    and moves its finish.  A tick that resizes nothing leaves the state as
    it was, so the event's later ticks do nothing either and cost no
    read."""
    m = state.mal
    c = m.ctx[k]
    T, p = c.tick_time.shape[0], m.ptr[k]
    wlo, whi, J = c.min_width, c.max_width, jobs.capacity
    moved = False
    while p < T and int(c.tick_time[p]) <= st.clock:
        p += 1
        counters["resize_ticks"] += 1
        width, jst = row(m.width), row(state.jstate)
        running = jst == RUNNING
        s_key = torch.where(running & (width > wlo), width, -1)
        g_key = torch.where(running & (width < whi), width, INF_TIME)
        rows = torch.arange(J, dtype=torch.int32, device=width.device)
        s_max, g_min = s_key.max(), g_key.min()
        s_vic = torch.where(s_key == s_max, rows, J).min()
        g_vic = torch.where(g_key == g_min, rows, J).min()
        fin = row(state.finish)
        reads = [torch.sum(torch.where(jst == WAITING, width, 0)), s_max,
                 g_min, s_vic, g_vic, fin[s_vic], fin[g_vic]]
        if st.lfb is not None:
            reads.append(_alloc.largest_free_run(
                _owner_eff(state, None if row is _solo_row else k)))
        demand, s_max, g_min, s_vic, g_vic, fin_s, fin_g, *lfb = torch.stack(
            [x.long() for x in reads]).tolist()
        counters["resize_reads"] += 1
        if lfb:
            st.lfb = lfb[0]
        do_shrink = demand >= c.shrink_threshold and s_max >= 0
        vic, fin_v = (s_vic, fin_s) if do_shrink else (g_vic, fin_g)
        w_v = int(row(m.width_host)[vic])
        cap = max(st.free, 0) if place is None else policies.placeable(st)
        d = min(c.step, whi - w_v, cap)
        do_grow = (demand < c.shrink_threshold
                   and demand <= c.grow_threshold and g_min < INF_TIME
                   and d > 0)
        if not (do_shrink or do_grow):
            while p < T and int(c.tick_time[p]) <= st.clock:
                p += 1
                counters["resize_ticks"] += 1
            break
        if do_shrink:
            d = min(c.step, w_v - wlo)
        new_w = w_v - d if do_shrink else w_v + d
        row(state.finish)[vic] = st.clock + _redilate(
            c, vic, fin_v - st.clock, w_v, new_w)
        st.free += d if do_shrink else -d
        if place is not None:
            own = row(state.node_owner)
            if do_shrink:
                mine = own == vic
                rank = torch.cumsum(mine.flip(0), 0,
                                    dtype=torch.int32).flip(0)
                own.masked_fill_(mine & (rank <= d), -1)
            else:
                own.masked_fill_(_alloc.place(
                    place[1], place[0],
                    _owner_eff(state, None if row is _solo_row else k), d),
                    vic)
            _refingerprint(state, row, place[0], vic)
            moved = True
        _mal_resize(m, row, vic, w_v, new_w, st.clock)
    m.ptr[k] = p
    return moved


def _streams_step(jobs: JobSet, state, st, k: int, row, host,
                  place, unfinished: int) -> tuple:
    """Member ``k``'s stream entries of this event, after its completions
    (``unfinished``: its jobs not DONE after them): the failure/repair
    entries, then the autoscaler ticks, then the resize ticks, each only
    while some job is not DONE (a finished member never drains its
    streams' tails).  ``host`` is the member's host columns, ``place``
    ``(machine, strategy)`` on a machine, else ``None``.  Returns
    ``(aborts, whether the map or its painted mask moved)``."""
    aborts, moved = 0, False
    if state.rel is not None and unfinished > 0:
        aborts, moved = _rel_entries(jobs, state, st, k, row, host, place)
    if state.svc is not None and unfinished - aborts > 0:
        moved |= _tick_entries(jobs, state, st, k, row, place is not None)
    if state.mal is not None and unfinished - aborts > 0:
        moved |= _resize_entries(jobs, state, st, k, row, place)
    return aborts, moved


def _solo_row(t):
    return t


def _clamp_due(clock: torch.Tensor, t_hi: int) -> torch.Tensor:
    """The clock an event's device updates use in a window bounded by
    ``t_hi``: ``clock`` clamped to ``t_hi`` (and below ``INF_TIME``, the
    nothing-is-due sentinel).  One operation that stands for the stop
    test: the clock is the least running finish and arrivable submit, so
    an event past the bound has none of either at or before the clamped
    clock, and completes and admits nothing; an event that is due keeps
    its clock."""
    return torch.clamp(clock, max=min(t_hi, INF_TIME - 1))


def _event_step(policy: int, jobs: JobSet, state: SimState,
                order: Optional[torch.Tensor] = None,
                ctx: Optional[AllocCtx] = None,
                log: Optional[_MapLog] = None,
                deps: Optional[DepList] = None,
                *, unfinished: int, t_hi: Optional[int] = None
                ) -> Optional[int]:
    """Process one event in place; returns the number of jobs it made DONE
    (completions and aborts: the host's count of unfinished jobs,
    ``unfinished`` before the event, drops by that much).  ``order`` is
    ``_fast_order``'s permutation (``None``: selector loop), ``deps`` the
    table's :func:`dep_list` (``None`` without edges).  With ``t_hi`` (a window) the event happens only
    when it is due by ``t_hi``: the completions test the clamped clock
    (:func:`_clamp_due`), so an event that is not due changes nothing on
    the device, and the host learns it from the event's one read and
    returns ``None`` before its stream entries and arrivals.  With a
    machine,
    completions free their nodes (before the one read, which then carries
    the largest free run, where that run is the cap; after it, and only
    when some job completed, elsewhere), and the event's (clock, free,
    painted map) row goes to the log after the pass.  With a stream the
    next entry's time bounds the clock.  The arrivals come after the one
    read and after the stream entries (:func:`_streams_step`), so that a
    released dependent or a requeued victim arrives in the same event.  In
    a malleable run completions free their widths and close their
    node-second segments on the device."""
    m = state.mal
    streams = (state.rel is not None or state.svc is not None
               or (m is not None and m.ctx[0].elastic))
    pending = state.jstate == PENDING
    running = state.jstate == RUNNING
    if deps is not None:   # an unreleased job is no arrival event
        pending &= state.n_unmet == 0
    # min over arrivals and completions at once == min(t_arr, t_fin)
    nxt = torch.where(pending, jobs.submit,
                      torch.where(running, state.finish, INF_TIME))
    clock = torch.min(nxt)
    if streams:
        clock = torch.clamp(clock, max=_stream_time(state, 0))
    completed = running & (state.finish <= (
        clock if t_hi is None else _clamp_due(clock, t_hi)))
    freed = torch.sum(torch.where(completed, policies.node_column(jobs, state),
                                  0))
    if m is not None:
        m.node_s += torch.where(completed, m.width * (clock - m.seg_start), 0)
    state.jstate = torch.where(completed, DONE, state.jstate).to(torch.int32)
    if deps is not None:
        state.n_unmet -= count_deps(deps, completed)
    reads = [clock.to(torch.int64), freed, torch.sum(completed)]
    if state.lfb is not None:
        _release_nodes(state.node_owner, completed)
        reads.append(_alloc.largest_free_run(_owner_eff(state)).long())
    clock, freed, n_completed, *lfb = torch.stack(reads).tolist()
    if t_hi is not None and not (clock <= t_hi and clock < INF_TIME):
        return None
    if ctx is not None and state.lfb is None and n_completed:
        _release_nodes(state.node_owner, completed)
    state.clock = clock
    state.free += freed
    state.n_events += 1
    if lfb:
        state.lfb = lfb[0]
    if streams:
        aborts, moved = _streams_step(
            jobs, state, state, 0, _solo_row,
            policies.host_columns(jobs, state),
            None if ctx is None else (ctx.machine, ctx.strategy),
            unfinished - n_completed)
        n_completed += aborts
        if moved and state.lfb is not None:
            state.lfb = int(_alloc.largest_free_run(_owner_eff(state)))
            counters["stream_reads"] += 1
    arrived = (state.jstate == PENDING) & (jobs.submit <= clock)
    if deps is not None:
        arrived &= state.n_unmet == 0
    state.jstate = torch.where(arrived, WAITING, state.jstate).to(torch.int32)
    _schedule_pass(policy, jobs, state, order, ctx)
    slot = state.n_events - 1
    # a window's log may be shorter than its events (replay keeps none):
    # writes past it drop, as the reference's
    if ctx is not None and slot < state.ev_time.shape[-1]:
        state.ev_time[slot] = state.clock
        state.ev_free[slot] = state.free
        log.add(_owner_eff(state), slot)
    return n_completed


def policies_id(policy) -> int:
    if isinstance(policy, str):
        return POLICY_IDS[policy.lower()]
    return int(policy)


def _event_cap(J: int, fctx, sctx, mctx=None) -> int:
    """The default event cap, as in the reference: ``6 J + 8``, plus ``6
    F`` with a failure stream of capacity ``F`` (a kill adds at most a
    start and a completion, and two entries), plus the ``T`` autoscaler
    ticks and the resize ticks."""
    cap = 6 * J + 8
    if fctx is not None:
        cap += 6 * fctx.capacity
    if sctx is not None:
        cap += sctx.tick_time.shape[-1]
    if mctx is not None:
        cap += mctx.tick_time.shape[-1]
    return cap


def _check_malleable(mctxs, J: int, contention: bool, pols) -> None:
    """Refuse what the reference refuses with a malleable plan: contention
    (the speedup curve already maps width to runtime), preempt (a
    suspended job's width bookkeeping is undefined), a plan whose rows are
    not the table's capacity; and an ensemble's plans of different tick
    counts."""
    if mctxs is None:
        return
    if contention:
        raise ValueError(
            "malleable jobs cannot be combined with contention "
            "dilation; the speedup curve owns the width->runtime map")
    if PREEMPT in pols:
        raise ValueError(
            "malleable jobs cannot be combined with the preempt "
            "policy; a suspended job's width bookkeeping is undefined")
    for c in mctxs:
        if c.dur.shape[0] != J:
            raise ValueError(
                f"malleable plan rows ({c.dur.shape[0]}) do not match "
                f"the job-table capacity ({J}); materialize "
                "the plan with capacity == the padded job capacity")
    ticks = {c.tick_time.shape[-1] for c in mctxs}
    if len(ticks) > 1:
        raise ValueError(f"an ensemble's members need one shape of stream; "
                         f"got resize tick counts {sorted(ticks)}")


def _check_streams(machine, fctxs, sctxs, J: int) -> None:
    """Refuse what the reference refuses: failures on a machine with an
    autoscaler (the down and offline masks would double-count the free
    counter), a deadline column that is not the table's length, and an
    ensemble's streams of different shapes."""
    if (machine is not None and fctxs is not None and sctxs is not None
            and any(c.tick_time.shape[-1] > 0 for c in sctxs)):
        raise ValueError(
            "machine-mode failures cannot be combined with an active "
            "autoscaler; drop machine=, failures=, or autoscale")
    for c in sctxs or ():
        if c.deadline.shape[-1] != J:
            raise ValueError(
                f"service plan has {c.deadline.shape[-1]} deadline rows but "
                f"the job table's capacity is {J}; pad the table to the "
                "plan's max_jobs")
    # an ensemble's members share one event cap and one capacity log
    # shape, as the reference's stacked streams share one shape
    for what, sizes in (("failure capacities", {c.capacity for c in
                                                fctxs or ()}),
                        ("tick counts", {c.tick_time.shape[-1] for c in
                                         sctxs or ()})):
        if len(sizes) > 1:
            raise ValueError(f"an ensemble's members need one shape of "
                             f"stream; got {what} {sorted(sizes)}")


def simulate(jobs: JobSet, policy, total_nodes: int, *, machine=None,
             alloc=None, contention=None, failures=None, service=None,
             malleable=None, max_events: Optional[int] = None,
             device=None) -> SimResult:
    """Run the whole simulation of one cluster.

    Without ``machine`` the engine runs in scalar-counter mode.  With a
    ``repro_torch.alloc.Machine`` of ``total_nodes`` nodes each start places
    concrete nodes under the ``alloc`` strategy (a name or id, default
    ``simple``), ``contention`` (``None``, ``(num, den)`` or a
    ``Contention``) dilates runtimes by the allocation's span, and the
    result carries the allocation fingerprints and the per-event
    fragmentation log.  ``failures`` (``None``, a ``FailureModel``, a
    ``FailureTrace`` or a ``FailCtx``) switches on node failures (DESIGN.md
    §15), ``service`` (``None``, a ``ServiceTrace``, a ``ServicePlan`` or
    a ``SvcCtx``) the serving plan's deadlines and autoscaler (§16), and
    ``malleable`` (``None``, a ``MalleablePlan`` or a ``MalCtx``) malleable
    jobs (§17): moldable width choice at dispatch and, in elastic mode,
    resize ticks and failure shrinks; it refuses contention and preempt.
    ``device=None`` runs on ``cuda`` (and raises without one); the job
    table and the machine move there if they lie elsewhere.
    ``max_events`` caps the event count (default ``6 * capacity + 8``,
    plus ``6 * max_failures`` and the tick counts, as in the reference).
    """
    ctx = make_alloc_ctx(machine, alloc, contention, total_nodes)
    fctx = make_fail_ctx(failures, n_nodes=int(total_nodes))
    sctx = make_svc_ctx(service, n_nodes=int(total_nodes))
    mctx = make_mal_ctx(malleable)
    _check_streams(machine, None if fctx is None else [fctx],
                   None if sctx is None else [sctx], jobs.capacity)
    policy = min(max(policies_id(policy), 0), len(policies.SELECTORS) - 1)
    _check_malleable(None if mctx is None else [mctx], jobs.capacity,
                     contention is not None, [policy])
    device = resolve_device(device)
    if jobs.device != device:
        jobs = jobs.to(device)
    if ctx is not None and ctx.machine.device != device:
        ctx = ctx._replace(machine=ctx.machine.to(device))
    cap = (max_events if max_events is not None
           else _event_cap(jobs.capacity, fctx, sctx, mctx))
    state = SimState.init(jobs, total_nodes,
                          None if ctx is None else ctx.machine, cap,
                          fctx, sctx, mctx)
    if ctx is not None and ctx.strategy == _alloc.CONTIGUOUS:
        state.lfb = ctx.machine.n_nodes
    order = _fast_order(jobs, policy, None if ctx is None else ctx.strategy,
                        mctx is not None)
    log = None if ctx is None else _MapLog(state.node_owner, state.ev_lfb)
    deps = dep_list(jobs)
    jobs.selector.bind_stream()
    unfinished = int(torch.sum(jobs.valid))
    while unfinished > 0 and state.n_events < cap:
        unfinished -= _event_step(policy, jobs, state, order, ctx, log, deps,
                                  unfinished=unfinished)
    if log is not None:
        log.flush()
    return result_from_state(jobs, state)


# ---------------------------------------------------------------------------
# the conservative window (DESIGN.md §2)
# ---------------------------------------------------------------------------

def _next_time(jobs: JobSet, state) -> torch.Tensor:
    """The next arrival or completion time of each table (``[...]`` on
    the device), ``INF_TIME`` when none: a PENDING job with unmet
    dependencies is no arrival."""
    pending = state.jstate == PENDING
    if jobs.dep_dst is not None:
        pending &= state.n_unmet == 0
    return torch.where(pending, jobs.submit, torch.where(
        state.jstate == RUNNING, state.finish, INF_TIME)).amin(dim=-1)


def next_event_time(jobs: JobSet, state: SimState) -> int:
    """The time of the state's next arrival or completion, ``INF_TIME``
    when none (the reference's ``next_event_time``): one read."""
    return int(_next_time(jobs, state))


def simulate_window(policy, jobs: JobSet, state: SimState, t_hi: int,
                    max_events: int, ctx: Optional[AllocCtx] = None,
                    rel=None) -> tuple:
    """Process every event with time ``<= t_hi`` (a conservative window),
    in place; returns ``(state, saturated)``.

    The multicluster engine steps its clusters' windows in lockstep
    (:func:`simulate_window_batch`), the streaming replay runner
    (``repro_torch.replay``) calls this once a round.  The loop stops when
    the next event is past ``t_hi`` or is ``INF_TIME`` (nothing is due:
    a drain at ``t_hi = INF_TIME`` ends without spinning), or when
    ``state.n_events`` reaches ``max_events`` (a total, so a state carried
    across calls shares one cap).  ``saturated`` is true when the cap
    stopped the loop with an event still due: the state is then a valid
    prefix of the round.

    The stop test is the event's own (:func:`_event_step`'s ``t_hi``):
    the step's completions test the clock clamped to ``t_hi`` on the
    device (one operation) and the host reads the true clock with the
    event's one read, so an event that is not due changes nothing and
    costs no more than an event that is.  The unfinished
    count is taken from ``jstate != DONE`` at the call's start, so a row
    that is PENDING but invalid (replay's sentinel) keeps the run open, as
    the reference's liveness guard does.  Releases scatter-add over the
    call's edge list (:func:`dep_list`), which holds in any edge order.
    The blocking order is the call's table's.

    ``ctx`` is ``make_alloc_ctx``'s (``None``: scalar-counter mode); under
    ``contiguous`` a state without the host's largest free run reads it
    once.  The state's event log takes the events that fit in it; those
    past it drop.  ``rel`` (anything ``simulate``'s ``failures`` takes) is
    the failure stream, a clock source while some job is not DONE; the
    state must carry its reliability state (``SimState.init(...,
    failures=)``), whose pointer the stream starts from.  A state that
    carries a stream needs ``rel``, and a service or malleable plan is
    refused: the reference's window takes neither."""
    if state.svc is not None or state.mal is not None:
        raise ValueError("simulate_window runs no service or malleable "
                         "plan, as the reference's takes none")
    if (rel is None) != (state.rel is None):
        raise ValueError(
            "rel= and the state's reliability state go together: "
            "SimState.init(..., failures=) for a window with rel=")
    if rel is not None:
        state.rel.ctx = [make_fail_ctx(rel)]
    policy = min(max(policies_id(policy), 0), len(policies.SELECTORS) - 1)
    t_hi, max_events = int(t_hi), int(max_events)
    if ctx is not None and ctx.machine.device != jobs.device:
        ctx = ctx._replace(machine=ctx.machine.to(jobs.device))
    if (ctx is not None and ctx.strategy == _alloc.CONTIGUOUS
            and state.lfb is None):
        state.lfb = int(_alloc.largest_free_run(_owner_eff(state)))
    order = _fast_order(jobs, policy, None if ctx is None else ctx.strategy)
    log = None if ctx is None else _MapLog(state.node_owner, state.ev_lfb)
    deps = dep_list(jobs)
    jobs.selector.bind_stream()
    unfinished = int(torch.sum(state.jstate != DONE))
    while unfinished > 0 and state.n_events < max_events:
        n = _event_step(policy, jobs, state, order, ctx, log, deps,
                        unfinished=unfinished, t_hi=t_hi)
        if n is None:
            break
        unfinished -= n
    if log is not None:
        log.flush()
    saturated = False
    if unfinished > 0 and state.n_events >= max_events:
        due = next_event_time(jobs, state)
        if state.rel is not None:
            due = min(due, _stream_time(state, 0))
        saturated = due <= t_hi and due < INF_TIME
    return state, saturated


# ---------------------------------------------------------------------------
# ensembles: B members in lockstep
# ---------------------------------------------------------------------------

class BatchAlloc(NamedTuple):
    """An ensemble's allocation context: one machine for every member, and
    each member's strategy id and contention model (host values);
    ``contention`` stacks them as i32[B] tensors on the table's device."""

    machine: _alloc.Machine
    strategies: list
    contentions: list
    contention: _alloc.Contention

    @classmethod
    def make(cls, machine, strategies, contentions, device) -> "BatchAlloc":
        return cls(machine, strategies, contentions,
                   _alloc.Contention.stack(contentions, device))

    def contention_of(self, m: torch.Tensor, ms) -> _alloc.Contention:
        """The members ``m`` (device) / ``ms`` (host) of ``contention``;
        host ``off`` when none of them dilates."""
        if not any(self.contentions[b].enabled for b in ms):
            return _alloc.Contention.off()
        c = self.contention
        return _alloc.Contention(c.enabled[m], c.alpha_num[m],
                                 c.alpha_den[m])


def _read_lfb(state: EnsembleState, ms, counter: str = "cap_reads") -> None:
    """Read the largest free run of the members ``ms`` whose cap it is
    (``contiguous``) into their host scalars: one read for all of them,
    counted under ``counter``."""
    ms = [b for b in ms if state.members[b].lfb is not None]
    if not ms:
        return
    m = _to_device([ms], state.node_owner.device)[0]
    lfb = _alloc.largest_free_run(_owner_eff(state, m)).tolist()
    counters[counter] += 1
    for b, v in zip(ms, lfb):
        state.members[b].lfb = v


def _arrive_batch(jobs: JobSet, state: EnsembleState, clock: torch.Tensor,
                  active: Optional[torch.Tensor], has_edges: bool) -> None:
    """Every active member's arrivals at its ``clock`` (i32[B]), in place,
    after the event's read and the members' stream entries."""
    arrived = (state.jstate == PENDING) & (jobs.submit <= clock[:, None])
    if active is not None:
        arrived &= active[:, None]
    if has_edges:
        arrived &= state.n_unmet == 0
    state.jstate.copy_(torch.where(arrived, WAITING, state.jstate))


def _event_step_batch(jobs: JobSet, state: EnsembleState,
                      active: Optional[torch.Tensor],
                      actx: Optional[BatchAlloc] = None,
                      deps: Optional[DepList] = None,
                      t_stream: Optional[torch.Tensor] = None,
                      t_hi: Optional[int] = None) -> tuple:
    """:func:`_event_step`'s event for every member at once, over the
    ``[B, J]`` state, written in place.  ``active`` (bool[B], ``None`` for
    every member) masks the members that are done, whose state is left as
    it is; ``deps`` is the stack's :func:`dep_list` (``[B, ...]``, ``None``
    without edges).  One read: ``[clock, freed, n_completed]`` for each
    member (a done member's row means nothing), with the largest free run
    after the completions as a fourth column when some member's cap is
    that run.  With streams, ``t_stream`` (i32[B] on the device) bounds
    each member's clock.  In a malleable run completions free their
    widths and close their node-second segments.  The arrivals are left
    to the caller
    (:func:`_arrive_batch`, after the stream entries).  With ``t_hi`` (the
    lockstep window) the completions and the arrivals test each member's
    clamped clock (:func:`_clamp_due`), so a member whose event is past
    ``t_hi`` is left as it is; the rows read carry the true clocks.
    Returns the read rows and the clocks for the arrivals, on the
    device."""
    pending = state.jstate == PENDING
    running = state.jstate == RUNNING
    if deps is not None:
        pending &= state.n_unmet == 0
    nxt = torch.where(pending, jobs.submit,
                      torch.where(running, state.finish, INF_TIME))
    clock = torch.amin(nxt, dim=1)
    if t_stream is not None:
        clock = torch.minimum(clock, t_stream)
    clock_m = clock if t_hi is None else _clamp_due(clock, t_hi)
    completed = running & (state.finish <= clock_m[:, None])
    if active is not None:
        completed &= active[:, None]
    freed = torch.sum(torch.where(completed, policies.node_column(jobs, state),
                                  0), dim=1)
    m = state.mal
    if m is not None:
        m.node_s += torch.where(completed,
                                m.width * (clock[:, None] - m.seg_start), 0)
    state.jstate.copy_(torch.where(completed, DONE, state.jstate))
    if deps is not None:   # a done member completes nothing: no decrement
        state.n_unmet -= count_deps(deps, completed)
    reads = [clock.to(torch.int64), freed, torch.sum(completed, dim=1)]
    if actx is not None:
        _release_nodes(state.node_owner, completed)
        if _alloc.CONTIGUOUS in actx.strategies:
            reads.append(_alloc.largest_free_run(_owner_eff(state)).long())
    return torch.stack(reads, dim=1).tolist(), clock_m


def _to_device(rows, device) -> torch.Tensor:
    """Host ints (a list of equal-length lists) as one int64 tensor on
    ``device``: one copy for all of a round's per-member scalars."""
    return torch.tensor(rows, dtype=torch.int64).to(device)


def _start_batch(jobs: JobSet, state: EnsembleState, hosts, reqs,
                 actx: Optional[BatchAlloc] = None) -> None:
    """:func:`_start_job` for one job of each member in ``reqs`` (pairs of
    member and row): one indexed write a column for all of them.  With a
    machine, one placement over the members' rows (one call a strategy
    among them), and one read of the new largest free runs where they are
    the cap.  In a malleable run each member chooses its job's width on
    the host first (:func:`_mal_dispatch`)."""
    ms = [b for b, _ in reqs]
    ix = [i for _, i in reqs]
    clk = [state.members[b].clock for b in ms]
    rsv = [c + int(hosts[b]["estimate"][i]) for b, i, c in zip(ms, ix, clk)]
    mal = state.mal
    cols = [ms, ix, clk, rsv]
    if mal is not None:
        cols += [list(x) for x in zip(*(
            _mal_dispatch(mal, b, lambda t, b=b: t[b], i,
                          policies.placeable(state.members[b]))
            for b, i in reqs))]
    m, i, c, r, *wall = _to_device(cols, jobs.device).unbind(0)
    c = c.to(torch.int32)
    if mal is not None:
        need, wall = (x.to(torch.int32) for x in wall)
        mal.width[m, i] = need
        mal.seg_start[m, i] = c
    else:
        need = jobs.nodes[m, i]
    state.jstate[m, i] = RUNNING
    state.start[m, i] = torch.minimum(state.start[m, i], c)
    if state.rel is not None:
        state.rel.last_start[m, i] = c
    if actx is None:
        state.finish[m, i] = (state.remaining[m, i] if mal is None
                              else wall) + c
    else:
        own = state.node_owner[m]
        mask = _alloc.place_batch([actx.strategies[b] for b in ms],
                                  actx.machine, _owner_eff(state, m), need)
        span = _alloc.group_span(actx.machine, mask)
        first, asum = _alloc.alloc_fingerprint(mask)
        state.node_owner[m] = torch.where(mask, i[:, None].to(torch.int32),
                                          own)
        state.alloc[m, :, i] = torch.stack([first, span, asum], dim=1)
        state.finish[m, i] = (_alloc.dilate(actx.contention_of(m, ms),
                                            state.remaining[m, i], span)
                              if mal is None else wall) + c
    state.rsv_finish[m, i] = r.to(torch.int32)
    for b, idx in reqs:
        state.members[b].free -= int(hosts[b]["nodes"][idx])
    if actx is not None:
        _read_lfb(state, ms)


def _prefix_batch(jobs: JobSet, state: EnsembleState, order: torch.Tensor,
                  ms, hosts, actx: Optional[BatchAlloc] = None) -> None:
    """:func:`_batched_pass` for the members ``ms``, along ``dim=1``;
    ``order`` is ``[B, J]``, each member's permutation in its row.  With a
    machine the host reads every member's started rows in key order and
    starts the k-th of each member together (:func:`_start_batch`)."""
    m, free, clk = _to_device(
        [ms, [state.members[b].free for b in ms],
         [state.members[b].clock for b in ms]], jobs.device).unbind(0)
    order, jst, nodes = order[m], state.jstate[m], jobs.nodes[m]
    w_sorted = torch.gather(jst == WAITING, 1, order)
    cum = torch.cumsum(torch.where(w_sorted, torch.gather(nodes, 1, order), 0),
                       1, dtype=torch.int32)
    take = (cum <= free[:, None]) & w_sorted
    if actx is not None:
        pos = torch.nonzero(take)
        rows = [[] for _ in ms]
        for k, idx in zip(*torch.stack([pos[:, 0], order[pos[:, 0],
                                                         pos[:, 1]]]).tolist()):
            rows[k].append(idx)
        for k in range(max(map(len, rows))):
            _start_batch(jobs, state, hosts, [
                (b, r[k]) for b, r in zip(ms, rows) if len(r) > k], actx)
        return
    started = torch.zeros_like(w_sorted).scatter_(1, order, take)
    clk = clk[:, None].to(torch.int32)
    start, finish, rsv = state.start[m], state.finish[m], state.rsv_finish[m]
    state.jstate[m] = torch.where(started, RUNNING, jst).to(torch.int32)
    state.start[m] = torch.where(started, torch.minimum(start, clk), start)
    state.finish[m] = torch.where(started, state.remaining[m] + clk, finish)
    state.rsv_finish[m] = torch.where(started, jobs.estimate[m] + clk, rsv)
    if state.rel is not None:
        last = state.rel.last_start
        last[m] = torch.where(started, clk, last[m])
    taken = torch.sum(torch.where(started, nodes, 0), dim=1).tolist()
    for b, t in zip(ms, taken):
        state.members[b].free -= t


def _suspend_batch(jobs: JobSet, state: EnsembleState, hosts, reqs,
                   actx: Optional[BatchAlloc] = None) -> None:
    """:func:`_preempt_for` for one head of each member in ``reqs`` (pairs
    of member and row), the two stable sorts along ``dim=1``; with a
    machine the victims free their nodes."""
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
    if actx is not None:
        own = state.node_owner[m]
        _release_nodes(own, victim)
        state.node_owner[m] = own
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
                    order, members, batched,
                    actx: Optional[BatchAlloc] = None) -> None:
    """Every member's scheduling pass of this event, in lockstep rounds
    (``batched[b]``: whether member ``b`` takes a batched pass).

    Each round sends every member still in its pass the answer to its last
    request and gathers its next one; then each kind of request is answered
    for all the members that made it at once: one batched launch for the
    selections, one for the walks, one indexed write or reduction for the
    rest.  Members touch only their own rows, so the order of the kinds
    within a round does not matter."""
    gens = {b: _pass(pols[b], hosts[b], state.members[b], batched[b])
            for b in members}
    answers = dict.fromkeys(gens)
    walks = dict.fromkeys(gens, 0)
    sel = jobs.selector
    nodes = None if state.mal is None else state.mal.width
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
                                   state.jstate, nodes=nodes)
            for (b, _), a in zip(reqs[SELECT], got):
                answers[b] = a
        if reqs[WALK]:
            got = sel.walk_batch([(b, r[1]) for b, r in reqs[WALK]],
                                 state.jstate, state.rsv_finish, nodes=nodes)
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
                           [(b, r[1]) for b, r in reqs[SUSPEND]], actx)
        if reqs[START]:
            _start_batch(jobs, state, hosts,
                         [(b, r[1]) for b, r in reqs[START]], actx)
        if reqs[PREFIX]:
            _prefix_batch(jobs, state, order, [b for b, _ in reqs[PREFIX]],
                          hosts, actx)
    if walks:
        counters["max_walks_per_event"] = max(
            counters["max_walks_per_event"], max(walks.values()))


def _log_events_batch(state: EnsembleState, members, log: _MapLog,
                      rnd: int) -> None:
    """Each stepped member's (clock, free, map) row of this event-round
    ``rnd`` (every active member's slot): the host columns in place, the
    maps into the log."""
    for b in members:
        st = state.members[b]
        state.ev_time[b, rnd] = st.clock
        state.ev_free[b, rnd] = st.free
    log.add(_owner_eff(state), rnd, state.n_events)


def _batch_order(jobs: JobSet, pols, batched) -> Optional[torch.Tensor]:
    """Each batched member's ``blocking_order`` in its row of one ``[B,
    J]`` permutation, or ``None`` when no member batches; the rows of the
    other members (FCFS order) are never read."""
    if not any(batched):
        return None
    return torch.stack([blocking_order(jobs.member(b), p if ok else FCFS)
                        for b, (p, ok) in enumerate(zip(pols, batched))])


def simulate_batch(jobs: JobSet, policies_b, total_nodes_b, *,
                   machine=None, alloc_b=None, contention_b=None,
                   failures_b=None, service_b=None, malleable_b=None,
                   max_events: Optional[int] = None) -> SimResult:
    """Run B members of a stacked table (``[B, J]`` columns) in lockstep.

    Member ``b`` runs policy ``policies_b[b]`` on ``total_nodes_b[b]``
    nodes, and its result equals :func:`simulate` of its own table bit for
    bit: an event step serves every member at once and every round of the
    scheduling passes answers each kind of request for every member with
    one launch (:func:`_schedule_batch`).  With ``machine`` (one machine on
    the table's device, shared by every member) member ``b`` places under
    ``alloc_b[b]`` (a canonical id) with ``contention_b[b]`` (a
    ``Contention``); members of different strategies share the batch, and
    each reads and writes only its own occupancy row.  ``failures_b`` and
    ``service_b`` give each member its ``FailCtx`` and ``SvcCtx`` (lists,
    or ``None``); each member keeps its own stream pointers and consumes
    its entries inside the lockstep event step, and its next entry's time
    bounds its clock through one device row ``t_stream`` written only when
    a pointer moves.  ``malleable_b`` gives each member its ``MalCtx``: its
    own ``[J]`` row of widths, host copy and tick pointer (no member may
    dilate by contention or preempt).  A member is done once it has no
    unfinished job or has reached its event cap; from then on its state is
    never written again ("max iterations across members, finished carries
    preserved", DESIGN.md §18.1), nor are its streams drained.  Runs on
    the table's device."""
    B = jobs.batch
    if B is None:
        raise ValueError("simulate_batch needs a stacked [B, J] table")
    pols = [min(max(policies_id(p), 0), len(policies.SELECTORS) - 1)
            for p in policies_b]
    if len(pols) != B or len(total_nodes_b) != B:
        raise ValueError(f"{len(pols)} policies and {len(total_nodes_b)} "
                         f"node counts for {B} members")
    for name, ctxs in (("failures_b", failures_b), ("service_b", service_b),
                       ("malleable_b", malleable_b)):
        if ctxs is not None and len(ctxs) != B:
            raise ValueError(f"{len(ctxs)} {name} contexts for {B} members")
    _check_streams(machine, failures_b, service_b, jobs.capacity)
    _check_malleable(malleable_b, jobs.capacity,
                     any(c.enabled for c in contention_b or ()), pols)
    cap = max_events if max_events is not None else _event_cap(
        jobs.capacity, None if failures_b is None else failures_b[0],
        None if service_b is None else service_b[0],
        None if malleable_b is None else malleable_b[0])
    run = _BatchRun(jobs, pols, total_nodes_b, cap, machine=machine,
                    alloc_b=alloc_b, contention_b=contention_b,
                    failures_b=failures_b, service_b=service_b,
                    malleable_b=malleable_b)
    members = [b for b in range(B) if run.unfinished[b] > 0 and cap > 0]
    while members:
        run.step(members)
        members = [b for b in members if run.unfinished[b] > 0
                   and run.state.members[b].n_events < cap]
    if run.log is not None:
        run.log.flush(run.state.n_events)
    return result_from_state(jobs, run.state)


class _BatchRun:
    """The part of a lockstep run that lives across calls: the ensemble
    state, the members' host rows and pass kinds, their blocking orders,
    the release structure, the streams' next times, the device mask of
    the members stepping and the event log.

    :func:`simulate_batch` steps it until every member is done; the
    lockstep window (:func:`simulate_window_batch`) steps it up to a bound,
    call after call, and a multicluster exchange rebinds it to the
    exchanged table (:meth:`bind`)."""

    def __init__(self, jobs: JobSet, pols, total_nodes_b, cap: int, *,
                 machine=None, alloc_b=None, contention_b=None,
                 failures_b=None, service_b=None, malleable_b=None):
        self.pols, self.rnd = pols, 0
        B = jobs.batch
        self.actx = None
        if machine is not None:
            self.actx = BatchAlloc.make(machine, list(alloc_b),
                                        list(contention_b), jobs.device)
        self.state = state = EnsembleState.init(
            jobs, total_nodes_b, machine, cap, failures_b, service_b,
            malleable_b)
        if self.actx is not None:
            for b, s in enumerate(self.actx.strategies):
                if s == _alloc.CONTIGUOUS:
                    state.members[b].lfb = machine.n_nodes
        self.malleable = malleable_b is not None
        self.log = (None if self.actx is None
                    else _MapLog(state.node_owner, state.ev_lfb))
        self.streams = (state.rel is not None or state.svc is not None
                        or any(c.elastic for c in malleable_b or ()))
        self.t_host = self.t_stream = None
        if self.streams:
            self.t_host = [_stream_time(state, b) for b in range(B)]
            self.t_stream = torch.tensor(self.t_host, dtype=torch.int32).to(
                jobs.device)
        self.active, self.masked = None, list(range(B))
        self.bind(jobs)
        self.unfinished = torch.sum(state.jstate != DONE, dim=1).tolist()

    def bind(self, jobs: JobSet) -> None:
        """Run on ``jobs`` from now on (a new table after an exchange, whose
        cached host copy and selector are its own): the members' host rows
        (a malleable member's widths in place of ``nodes``), each member's
        pass kind by its own table's edges as its solo run's, the blocking
        orders, and the release structure (:func:`dep_list`)."""
        self.jobs = jobs
        host, state, B = jobs.host, self.state, jobs.batch
        self.hosts = [{f: a[b] for f, a in host.items()} for b in range(B)]
        if state.mal is not None:   # each member's passes read its widths
            for b in range(B):
                self.hosts[b]["nodes"] = state.mal.width_host[b]
        edged = [jobs.dep_dst is not None
                 and bool((h["dep_dst"] < jobs.capacity).any())
                 for h in self.hosts]
        self.batched = [
            _batches(p, None if self.actx is None else self.actx.strategies[b],
                     edged[b], self.malleable)
            for b, p in enumerate(self.pols)]
        self.order = _batch_order(jobs, self.pols, self.batched)
        self.deps = dep_list(jobs)
        jobs.selector.bind_stream()

    def step(self, members, t_hi: Optional[int] = None) -> list:
        """One lockstep event of ``members`` (ascending): with ``t_hi``
        only of those whose event is due by it.  Returns the members that
        stepped."""
        jobs, state, actx = self.jobs, self.state, self.actx
        B = jobs.batch
        if members != self.masked:   # members left: mask them from now
            mask = [False] * B
            for b in members:
                mask[b] = True
            self.active = torch.tensor(mask).to(jobs.device)
            self.masked = list(members)
        stepped, clock_d = _event_step_batch(
            jobs, state, self.active, actx, self.deps, self.t_stream, t_hi)
        if t_hi is not None:
            members = [b for b in members
                       if stepped[b][0] <= t_hi and stepped[b][0] < INF_TIME]
        for b in members:
            clock, freed, n_completed, *lfb = stepped[b]
            st = state.members[b]
            st.clock = clock
            st.free += freed
            st.n_events += 1
            if st.lfb is not None:
                st.lfb = lfb[0]
            self.unfinished[b] -= n_completed
        if self.streams:
            moved = []
            for b in members:
                aborts, mv = _streams_step(
                    jobs, state, state.members[b], b,
                    lambda t, b=b: t[b], self.hosts[b],
                    None if actx is None else (actx.machine,
                                               actx.strategies[b]),
                    self.unfinished[b])
                self.unfinished[b] -= aborts
                if mv:
                    moved.append(b)
                t = _stream_time(state, b)
                if t != self.t_host[b]:
                    self.t_host[b] = t
                    self.t_stream[b] = t
            if moved:
                _read_lfb(state, moved, "stream_reads")
        _arrive_batch(jobs, state, clock_d, self.active,
                      self.deps is not None)
        _schedule_batch(jobs, state, self.pols, self.hosts, self.order,
                        members, self.batched, actx)
        if self.log is not None:
            _log_events_batch(state, members, self.log, self.rnd)
        self.rnd += 1
        return members


def simulate_window_batch(run: _BatchRun, t_hi: int,
                          max_events: int) -> list:
    """:func:`simulate_window` for every member of a lockstep run at once
    (the counterpart of ``jax.vmap(simulate_window)``): process each
    member's events with time ``<= t_hi``, members in lockstep, in place.
    Returns each member's ``saturated`` flag.

    A member stops stepping once its next event is past ``t_hi``, once
    nothing is due for it, or once its event count reaches ``max_events``
    (a total across calls), and its state is not written again in this
    call.  Every round of selections serves every stepping member with one
    batched ``queue_select`` launch.  The unfinished counts are taken from
    ``jstate != DONE`` at the call's start (one read).  The run must have
    no machine: members' event logs would take different slots."""
    if run.actx is not None:
        raise ValueError("the lockstep window runs scalar-counter members")
    state, jobs = run.state, run.jobs
    t_hi, max_events = int(t_hi), int(max_events)
    run.unfinished = torch.sum(state.jstate != DONE, dim=1).tolist()
    live = [b for b in range(jobs.batch) if run.unfinished[b] > 0]
    members = [b for b in live if state.members[b].n_events < max_events]
    while members:
        members = [b for b in run.step(members, t_hi)
                   if run.unfinished[b] > 0
                   and state.members[b].n_events < max_events]
    saturated = [False] * jobs.batch
    capped = [b for b in range(jobs.batch) if run.unfinished[b] > 0
              and state.members[b].n_events >= max_events]
    if capped:
        due = _next_time(jobs, state).tolist()
        for b in capped:
            d = due[b] if run.t_host is None else min(due[b], run.t_host[b])
            saturated[b] = d <= t_hi and d < INF_TIME
    return saturated
