"""Heap-based event-driven cluster scheduling simulator (CQsim analogue).

Counterpart of ``repro.refsim.sim``: the port's host oracle, plain Python
with ``heapq`` and numpy and no tensor in its loop.  It shares no code with
the port's engine (``core/engine.py``, ``core/policies.py``,
``core/parallel.py``) or its kernels, only the host layers both read (the
policy ids and ``dep_edge_arrays`` of ``core.jobs``, the merged failure
stream of ``reliability.model``, ``alloc.host`` and
``alloc.contention.dilate_host``), so that it is a second, independent
implementation of the engine's semantics.

Implements exactly the semantics pinned in DESIGN.md §8:
completions, then arrivals, then a scheduling pass that repeatedly applies
the policy selector until it blocks.  O(E log E) via a completion heap, but
the scheduling pass scans the waiting queue (like CQsim's list scan).

Dependencies (DESIGN.md §13): a job with unmet dependencies is invisible —
it generates no arrival event and never enters the waiting queue.  Its
release happens inside the completion step of its last dependency
(completions run before arrivals, mirroring the engine bit-for-bit),
and ``ready = max(submit, last dep finish)`` is recorded for the paper's
Fig. 7 wait metric.  A preempted job is WAITING, not DONE, so its
dependents stay blocked until it actually finishes.

Node allocation (DESIGN.md §11): given an ``alloc.Machine`` this
simulator maintains the same per-node occupancy map as the engine,
places nodes through the ``alloc.host`` mirrors (identical
tie-breaking), applies the same contention dilation, and reports the same
allocation fingerprints — the host-side oracle for bit-exact validation of
starts, finishes *and* node maps.

Reliability (DESIGN.md §15): given a ``reliability.FailureTrace``
this simulator walks the *same* merged failure/repair stream as the
engine (one shared stable sort, ``reliability.merge_stream``) with
the same kill rule — machine mode kills the failed node's owner, scalar
mode kills the job covering slot ``node % n_up`` of the row-order running
node cumsum — the same requeue/abort transitions, and the same checkpoint
rework accounting, recording every kill in an explicit ``kill_log`` the
differential tests audit ``n_restarts`` against.

Serving (DESIGN.md §16): given a ``serving.ServicePlan`` this
simulator carries the per-job SLO deadline column, fixes the met/missed
verdict at start time, and walks the *same* autoscaler tick stream as the
engine — one hysteresis rule application per consumed tick, after the
reliability stream and before arrivals, with scale-down bounded by the
free count (drain semantics: a running job is never stranded) and
machine-mode deactivation taking the highest-index free nodes /
reactivation the lowest-index offline ones.

Malleable jobs (DESIGN.md §17): given a ``malleable.MalleablePlan``
this simulator mirrors the two-level width decisions bit-exactly — the
moldable width choice at dispatch (min dilated duration among widths that
fit, narrowest on ties), the elastic one-resize-per-tick rule at the
plan's capacity ticks (shed from the widest running job under queue
pressure, grow the narrowest when the queue drains), the same pinned
float32 remaining-work rescale on every resize, and shrink-instead-of-kill
when a node failure hits a job running above its minimum width.  The
node-second ledger closes a segment at every width change exactly like
the engine's ``MalState`` accounting.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.alloc import contention as _con
from repro_torch.alloc import host as _host
from repro_torch.core.jobs import (
    BACKFILL, BESTFIT, FCFS, INF_TIME, LJF, PREEMPT, SJF, dep_edge_arrays,
)
from repro_torch.reliability.model import FAIL, REQUEUE, merge_stream
from repro_torch.traces.normalize import normalize_trace

_POL = {"fcfs": FCFS, "sjf": SJF, "ljf": LJF, "bestfit": BESTFIT,
        "backfill": BACKFILL, "preempt": PREEMPT}


def _ratio_ceil_host(r: int, dur_new: int, dur_old: int) -> int:
    """Remaining-work rescale on a width change — the engine's pinned
    float32 operation order ``ceil((f32(r) * f32(new)) / f32(old))``,
    floored at one tick (host mirror of ``engine._ratio_ceil``)."""
    v = (np.float32(r) * np.float32(dur_new)) / np.float32(dur_old)
    return max(int(np.ceil(v)), 1)


@dataclass
class _Job:
    idx: int
    submit: int
    runtime: int
    estimate: int
    nodes: int
    priority: int = 0
    start: int = -1
    finish: int = -1
    remaining: int = -1
    alloc_first: int = -1
    alloc_span: int = 0
    alloc_sum: int = 0
    last_start: int = -1   # latest dispatch (checkpoint base, shadow math)
    n_restarts: int = 0
    lost_work: int = 0
    aborted: bool = False
    # malleable state (``nodes`` holds the CURRENT effective width; the
    # original request is preserved separately for the output columns)
    prev_w: int = 0        # width backing ``remaining`` (0 = fresh job)
    n_resizes: int = 0
    node_s: int = 0        # closed node-second segments
    seg_start: int = 0     # open segment start (valid while RUNNING)
    disp_dur: int = -1     # dur-table entry at the latest dispatch


@dataclass
class ReferenceSimulator:
    total_nodes: int
    policy: str = "fcfs"
    machine: object = None          # alloc.Machine or its to_host() dict
    alloc: str = "simple"
    contention: object = None       # alloc.Contention, (num, den), or None
    failures: object = None         # reliability.FailureTrace or None
    service: object = None          # serving.ServicePlan or None
    malleable: object = None        # malleable.MalleablePlan or None
    jobs: List[_Job] = field(default_factory=list)
    dep_pairs: List[tuple] = field(default_factory=list)  # sorted-row indices
    _order: np.ndarray = None       # input-row -> sorted-row permutation

    def load(self, submit, runtime, nodes, estimate=None, priority=None,
             deps=None):
        submit = np.asarray(submit, dtype=np.int64)
        submit = submit - (submit.min() if len(submit) else 0)
        runtime = np.maximum(np.asarray(runtime, dtype=np.int64), 1)
        estimate = (
            np.maximum(np.asarray(estimate, dtype=np.int64), 1)
            if estimate is not None else runtime.copy()
        )
        nodes = np.minimum(np.maximum(np.asarray(nodes, dtype=np.int64), 1),
                           self.total_nodes)
        priority = (np.asarray(priority, dtype=np.int64) if priority is not None
                    else np.zeros(len(submit), dtype=np.int64))
        order = np.lexsort((np.arange(len(submit)), submit))
        self._order = order
        self.jobs = [
            _Job(i, int(submit[o]), int(runtime[o]), int(estimate[o]),
                 int(nodes[o]), int(priority[o]), remaining=int(runtime[o]))
            for i, o in enumerate(order)
        ]
        self.dep_pairs = []
        if deps is not None:
            # one shared normalizer (validation + cycle check + (submit, id)
            # sort permutation) with make_jobset, so both engines hold
            # bit-identical edge sets
            dst, src = dep_edge_arrays(deps, len(submit), order)
            self.dep_pairs = list(zip(dst.tolist(), src.tolist()))
        return self

    # ---- allocation helpers (mirror alloc) --------------------------------

    def _mach_host(self) -> Optional[Dict[str, np.ndarray]]:
        if self.machine is None:
            return None
        if isinstance(self.machine, dict):
            return self.machine
        return self.machine.to_host()

    def _alpha(self) -> tuple[int, int]:
        con = self.contention
        if con is None:
            return 0, 1
        if isinstance(con, tuple):
            return int(con[0]), int(con[1])
        if int(np.asarray(con.enabled)) == 0:
            return 0, 1
        return int(np.asarray(con.alpha_num)), int(np.asarray(con.alpha_den))

    # ---- policy selectors (mirror the engine's policies) -----------------

    def _select(self, waiting: List[_Job], running: List[_Job], free: int,
                cap: int, clock: int,
                bf: Optional[dict] = None) -> Optional[_Job]:
        if not waiting:
            return None
        pol = self.policy
        if pol in ("fcfs", "sjf", "ljf"):
            if pol == "fcfs":
                head = min(waiting, key=lambda j: j.idx)
            elif pol == "sjf":
                head = min(waiting, key=lambda j: (j.estimate, j.idx))
            else:
                head = min(waiting, key=lambda j: (-j.estimate, j.idx))
            return head if head.nodes <= cap else None
        if pol == "bestfit":
            feas = [j for j in waiting if j.nodes <= cap]
            if not feas:
                return None
            return min(feas, key=lambda j: (free - j.nodes, j.idx))
        if pol == "backfill":
            head = min(waiting, key=lambda j: j.idx)
            if head.nodes <= cap:
                if bf is not None:
                    bf.clear()  # a starting head invalidates any window
                return head
            # shadow via estimates of running jobs (free-count based, pinned;
            # keyed on the LATEST dispatch — the engine's rsv_finish — which
            # equals the first start unless a failure requeued the job)
            rel = sorted(
                (max(j.last_start + j.estimate, clock + 1), j.idx, j.nodes)
                for j in running
            )
            cum, shadow, extra, k_idx = free, None, free, -1
            for t, _idx, n in rel:
                cum += n
                if cum >= head.nodes:
                    shadow, extra, k_idx = t, cum - head.nodes, _idx
                    break
            if shadow is None:
                shadow, extra = None, free  # unreachable if nodes<=total
            if bf is not None and shadow is not None:
                # Decision-for-decision mirror of the engine's batched
                # backfill pass (DESIGN.md §18): within one scheduling pass
                # the pass carries (shadow, extra) as loop-invariant
                # structure, updating only the budget on each admission.
                # The oracle keeps recomputing from scratch and ASSERTS the
                # carried values match — the shadow-invariance theorem,
                # checked on every admission of every backfill run.  The
                # caller enables the carry only under a count-based cap:
                # the theorem's premise is free < head_need when the head
                # blocks, and the contiguous cap can geometry-block a
                # count-feasible head (an admission's own release may then
                # cover the head, legitimately moving the shadow earlier).
                # The pass loop clears the carry on a budget overdraw (a
                # release tie at the shadow can move the reach entry
                # within its tie group), so a present carry must match.
                if bf.get("head") == head.idx:
                    assert (bf["shadow"], bf["extra"], bf["k_idx"]) \
                        == (shadow, extra, k_idx), (
                        "backfill shadow invariance violated: carried "
                        f"(shadow={bf['shadow']}, extra={bf['extra']}, "
                        f"k_idx={bf['k_idx']}) != recomputed "
                        f"({shadow}, {extra}, {k_idx}) at clock {clock}")
                else:
                    bf["head"] = head.idx
                    bf["shadow"], bf["extra"] = shadow, extra
                    bf["k_idx"] = k_idx
            cands = [
                j for j in waiting
                if j is not head and j.nodes <= cap
                and ((shadow is not None and clock + j.estimate <= shadow)
                     or j.nodes <= min(free, extra))
            ]
            return min(cands, key=lambda j: j.idx) if cands else None
        if pol == "preempt":
            # queue order (priority, submit-rank); head may reclaim nodes
            # from strictly-lower-priority running jobs (engine mirror);
            # reclaim feasibility is free-count based by design
            head = min(waiting, key=lambda j: (j.priority, j.idx))
            reclaimable = sum(j.nodes for j in running
                              if j.priority > head.priority)
            return head if head.nodes <= free + reclaimable else None
        raise ValueError(f"unknown policy {pol!r}")

    # ---- event loop ---------------------------------------------------------

    def run(self) -> Dict[str, np.ndarray]:
        assert self.policy in _POL, self.policy
        jobs = self.jobs
        n = len(jobs)
        unmet = [0] * n             # unmet-dependency counts
        dependents: List[List[int]] = [[] for _ in range(n)]
        for t, d in self.dep_pairs:
            unmet[t] += 1
            dependents[d].append(t)
        # released-but-unarrived jobs as a min-heap of row indices; rows are
        # sorted by (submit, id), so index order IS arrival order and the
        # heap top always carries the next arrival time.  Jobs enter when
        # their last dependency completes (immediately for dep-free jobs),
        # keeping the no-deps path at the seed's O(E log E).
        rel_heap = [i for i in range(n) if unmet[i] == 0]
        heapq.heapify(rel_heap)
        n_unarrived = n
        last_dep_fin = [0] * n
        ready = [0] * n
        waiting: List[_Job] = []
        heap: List[tuple] = []  # (finish, idx)
        running: Dict[int, _Job] = {}
        free = self.total_nodes
        clock = 0
        n_events = 0

        mach = self._mach_host()
        alpha_num, alpha_den = self._alpha()
        owner = (np.full(self.total_nodes, -1, dtype=np.int64)
                 if mach is not None else None)
        ev_time: List[int] = []
        ev_free: List[int] = []
        ev_lfb: List[int] = []

        # reliability: the merged failure/repair stream (one shared stable
        # sort with the engine), outage bookkeeping, and the kill log
        fail = self.failures
        if fail is not None:
            st_time, st_node, st_kind = merge_stream(fail)
            n_stream = int((st_time < int(INF_TIME)).sum())
            requeue = int(fail.requeue) == REQUEUE
            ckpt = int(fail.checkpoint_interval)
            overhead = int(fail.restart_overhead)
        ptr = 0
        down = (np.zeros(self.total_nodes, dtype=bool)
                if (fail is not None and owner is not None) else None)
        kill_log: List[dict] = []
        live = n  # jobs not yet completed or aborted

        # serving: SLO deadlines plus the autoscaler tick stream (the same
        # hysteresis rule as engine._process_capacity_ticks, applied once
        # per consumed tick, after reliability and before arrivals)
        svc = self.service
        if svc is not None:
            tick = np.asarray(svc.tick_time, dtype=np.int64)
            svc_T = len(tick)
            svc_up, svc_down = int(svc.up_threshold), int(svc.down_threshold)
            svc_step, svc_min = int(svc.step), int(svc.min_nodes)
            svc_max = min(
                self.total_nodes if svc.max_nodes is None
                else int(svc.max_nodes), self.total_nodes)
            if owner is not None and down is not None and svc_T > 0:
                raise ValueError(
                    "machine-mode failures cannot be combined with an "
                    "active autoscaler (engine parity)")
        else:
            tick, svc_T = None, 0
        ptr_s = 0
        n_online = self.total_nodes
        svc_offline = (np.zeros(self.total_nodes, dtype=bool)
                       if (svc is not None and owner is not None) else None)
        cap_log: List[tuple] = []  # (tick time, online count after rule)

        # malleable: the plan's per-job width/duration table (rows are the
        # same (submit, id)-sorted order as self.jobs), the resize tick
        # stream, and the elastic thresholds.  While a plan is active
        # ``j.nodes`` holds the job's CURRENT effective width — min_width
        # while waiting, the chosen/resized width while running — so the
        # selectors, the free counter, the failure slot rule and the
        # autoscaler demand all read widths with no further changes.
        mal = self.malleable
        ptr_m = 0
        req_nodes: List[int] = []
        if mal is not None:
            if alpha_num != 0:
                raise ValueError(
                    "malleable jobs cannot be combined with contention "
                    "dilation (engine parity)")
            if self.policy == "preempt":
                raise ValueError(
                    "malleable jobs cannot be combined with the preempt "
                    "policy (engine parity)")
            m_dur = np.asarray(mal.dur, dtype=np.int64)
            m_tick = np.asarray(mal.tick_time, dtype=np.int64)
            m_T = len(m_tick)          # 0 = moldable (no resize ticks)
            m_wlo, m_whi = int(mal.min_width), int(mal.max_width)
            m_W = m_whi - m_wlo + 1
            m_step = int(mal.step)
            m_shrT = int(mal.shrink_threshold)
            m_groT = int(mal.grow_threshold)
            req_nodes = [j.nodes for j in jobs]
            for j in jobs:
                j.nodes = m_wlo        # effective width while waiting
        else:
            m_T = 0

        def resize(j: _Job, new_w: int) -> None:
            """Apply a width change to a RUNNING job: close the node-second
            segment, rescale the remaining work (pinned float32 rule),
            move the node map, and refresh the allocation fingerprints."""
            nonlocal free
            w = j.nodes
            d = new_w - w
            k_old, k_new = w - m_wlo, new_w - m_wlo
            j.node_s += w * (clock - j.seg_start)
            j.seg_start = clock
            j.finish = clock + _ratio_ceil_host(
                j.finish - clock, int(m_dur[j.idx][k_new]),
                int(m_dur[j.idx][k_old]))
            heapq.heappush(heap, (j.finish, j.idx))
            if owner is not None:
                if d < 0:
                    owned = np.nonzero(owner == j.idx)[0]
                    owner[owned[len(owned) + d:]] = -1  # shed highest-index
                else:
                    ids = _host.place_host(self.alloc, mach, owner_view(), d)
                    owner[ids] = j.idx
                owned = np.nonzero(owner == j.idx)[0]
                j.alloc_span = _host.group_span_host(mach, owned)
                j.alloc_first, j.alloc_sum = _host.fingerprint_host(owned)
            j.nodes = new_w
            j.prev_w = new_w
            j.n_resizes += 1
            free -= d

        def shrink_one(j: _Job, node: int) -> None:
            """Failure hit on a job above min width (elastic only): shed
            exactly the failed node instead of killing the job.  The freed
            slot nets to zero against the node going down."""
            nonlocal free
            w = j.nodes
            j.node_s += w * (clock - j.seg_start)
            j.seg_start = clock
            j.finish = clock + _ratio_ceil_host(
                j.finish - clock, int(m_dur[j.idx][w - 1 - m_wlo]),
                int(m_dur[j.idx][w - m_wlo]))
            heapq.heappush(heap, (j.finish, j.idx))
            j.nodes = w - 1
            j.prev_w = w - 1
            j.n_resizes += 1
            free += 1
            if owner is not None:
                owner[node] = -1
                owned = np.nonzero(owner == j.idx)[0]
                j.alloc_span = _host.group_span_host(mach, owned)
                j.alloc_first, j.alloc_sum = _host.fingerprint_host(owned)

        def owner_view() -> np.ndarray:
            """Occupancy map as the placement strategies see it: down and
            drained nodes painted with the out-of-range owner id ``n``
            (engine mirror)."""
            ov = owner
            if svc_offline is not None:
                ov = np.where(svc_offline, n, ov)
            if down is not None:
                ov = np.where(down, n, ov)
            return ov

        def cap_now() -> int:
            if owner is None:
                return free
            return _host.placeable_cap_host(self.alloc, owner_view())

        def kill(j: _Job, node: int) -> None:
            """Apply the requeue/abort rule to a job hit by a node failure."""
            nonlocal free, live
            el = clock - j.last_start
            saved = (el // ckpt) * ckpt if ckpt > 0 else 0
            lost = el - saved
            del running[j.idx]
            free += j.nodes
            if mal is not None:
                j.node_s += j.nodes * (clock - j.seg_start)
            if owner is not None:
                owner[owner == j.idx] = -1
            if requeue:
                j.remaining = max(j.finish - clock + lost + overhead, 1)
                j.finish = -1
                j.n_restarts += 1
                j.lost_work += lost + overhead
                if mal is not None:
                    j.nodes = m_wlo   # back to min width; prev_w keeps the
                                      # pre-kill width backing ``remaining``
                waiting.append(j)
            else:
                j.aborted = True
                j.finish = clock
                j.lost_work += el
                live -= 1
                for t in dependents[j.idx]:   # after-any release
                    unmet[t] -= 1
                    last_dep_fin[t] = max(last_dep_fin[t], clock)
                    if unmet[t] == 0:
                        heapq.heappush(rel_heap, t)
            kill_log.append({"time": clock, "node": node, "job": j.idx,
                             "requeued": requeue, "lost": lost})

        def more_events() -> bool:
            # a resize can leave a job's old (later) heap entry stale after
            # the rescheduled finish pops, so with malleable jobs a
            # non-empty heap no longer implies pending work — count live
            # jobs instead (same rule the failure path already needs)
            if fail is None and mal is None:
                return bool(n_unarrived or heap)
            return live > 0

        while more_events():
            while heap and (heap[0][1] not in running
                            or running[heap[0][1]].finish != heap[0][0]):
                heapq.heappop(heap)   # stale entry from a preemption/kill
            # released PENDING jobs only: a job with unmet dependencies
            # generates no arrival event (mirrors the engine's release rule)
            t_arr = jobs[rel_heap[0]].submit if rel_heap else None
            t_fin = heap[0][0] if heap else None
            t_rel = (st_time[ptr] if fail is not None and ptr < n_stream
                     else None)
            t_svc = None
            if ptr_s < svc_T and int(tick[ptr_s]) < int(INF_TIME):
                t_svc = int(tick[ptr_s])   # INF padding is never a source
            t_mal = None
            if ptr_m < m_T and int(m_tick[ptr_m]) < int(INF_TIME):
                t_mal = int(m_tick[ptr_m])  # INF clamp is never a source
            assert (t_arr is not None or t_fin is not None
                    or t_rel is not None or t_svc is not None
                    or t_mal is not None), \
                "deadlock: blocked jobs with no running dependency"
            clock = min(x for x in (t_arr, t_fin, t_rel, t_svc, t_mal)
                        if x is not None)
            n_events += 1
            # completions first (skip heap entries stale after preemption);
            # completing a job releases its dependents *now*, before the
            # arrival step of this same event
            while heap and heap[0][0] <= clock:
                fin, idx = heapq.heappop(heap)
                j = running.get(idx)
                if j is None or j.finish != fin:
                    continue  # stale: the job was preempted and re-queued
                del running[idx]
                free += j.nodes
                live -= 1
                if mal is not None:   # close the final node-second segment
                    j.node_s += j.nodes * (fin - j.seg_start)
                for t in dependents[idx]:
                    unmet[t] -= 1
                    last_dep_fin[t] = max(last_dep_fin[t], fin)
                    if unmet[t] == 0:
                        heapq.heappush(rel_heap, t)
                if owner is not None:
                    owner[owner == idx] = -1
            # reliability events: after completions (a job finishing at the
            # failure instant has completed), before arrivals (a dependent
            # of an aborted job releases within this same event)
            while fail is not None and ptr < n_stream \
                    and st_time[ptr] <= clock:
                node, kind = int(st_node[ptr]), int(st_kind[ptr])
                ptr += 1
                if kind == FAIL:
                    # elastic malleable jobs above min width shed the failed
                    # node instead of dying (DESIGN.md §17)
                    def hit(j: _Job, node: int) -> None:
                        if mal is not None and m_T > 0 and j.nodes > m_wlo:
                            shrink_one(j, node)
                        else:
                            kill(j, node)
                    if owner is not None:
                        if down[node]:
                            continue  # total-semantics guard (never renewal)
                        victim = int(owner[node])
                        down[node] = True
                        free -= 1
                        if victim >= 0:
                            hit(running[victim], node)
                    else:
                        # anonymous nodes: slot rule over the row-order
                        # running cumsum (engine mirror, DESIGN.md §15)
                        busy = sum(j.nodes for j in running.values())
                        n_up = free + busy
                        slot = node % max(n_up, 1)
                        free -= 1
                        if slot < busy:
                            cum = 0
                            for j in sorted(running.values(),
                                            key=lambda v: v.idx):
                                cum += j.nodes
                                if cum > slot:
                                    hit(j, node)
                                    break
                else:  # REPAIR
                    if owner is not None:
                        if not down[node]:
                            continue
                        down[node] = False
                    free += 1
            # autoscaler ticks: after reliability (capacity reacts to this
            # instant's failures), before arrivals (queued demand is read
            # BEFORE this event's arrivals join the queue — engine mirror)
            while ptr_s < svc_T and int(tick[ptr_s]) <= clock and live > 0:
                demand = sum(j.nodes for j in waiting)
                up = demand >= svc_up
                dn = (not up) and demand <= svc_down
                k_up = min(max(svc_max - n_online, 0), svc_step) if up else 0
                k_down = (min(max(n_online - svc_min, 0), svc_step,
                              max(free, 0)) if dn else 0)
                if svc_offline is not None:
                    if k_up:
                        # reactivate the lowest-index offline nodes
                        ids = np.nonzero(svc_offline)[0][:k_up]
                        svc_offline[ids] = False
                    if k_down:
                        # drain the highest-index FREE online nodes; the
                        # free counter bounds k_down, so a busy node is
                        # never taken (no running job is ever stranded)
                        cand = np.nonzero((owner < 0) & ~svc_offline)[0]
                        assert len(cand) >= k_down, "autoscale drain invariant"
                        svc_offline[cand[len(cand) - k_down:]] = True
                n_online += k_up - k_down
                free += k_up - k_down
                cap_log.append((int(tick[ptr_s]), n_online))
                ptr_s += 1
            # malleable resize ticks: after the autoscaler (resize reacts to
            # this instant's capacity), before arrivals (queue pressure is
            # read BEFORE this event's arrivals join — engine mirror).  At
            # most ONE job resizes per tick: under pressure the widest
            # running job above min width sheds up to ``step`` nodes (tie →
            # lowest row); when the queue drains the narrowest below max
            # width grows, bounded by step, headroom and placeable capacity.
            while ptr_m < m_T and int(m_tick[ptr_m]) <= clock and live > 0:
                demand = sum(j.nodes for j in waiting)
                if demand >= m_shrT:
                    cands = [j for j in running.values() if j.nodes > m_wlo]
                    if cands:
                        vic = min(cands, key=lambda j: (-j.nodes, j.idx))
                        d = min(m_step, vic.nodes - m_wlo)
                        resize(vic, vic.nodes - d)
                elif demand <= m_groT:
                    cands = [j for j in running.values() if j.nodes < m_whi]
                    if cands:
                        vic = min(cands, key=lambda j: (j.nodes, j.idx))
                        gcap = (max(free, 0) if owner is None else
                                _host.placeable_cap_host(self.alloc,
                                                         owner_view()))
                        d = min(m_step, m_whi - vic.nodes, gcap)
                        if d > 0:
                            resize(vic, vic.nodes + d)
                ptr_m += 1
            # arrivals: submit reached AND all dependencies DONE
            while rel_heap and jobs[rel_heap[0]].submit <= clock:
                i = heapq.heappop(rel_heap)
                ready[i] = max(jobs[i].submit, last_dep_fin[i])
                waiting.append(jobs[i])
                n_unarrived -= 1
            # scheduling pass — ``bf`` carries the backfill window's
            # (shadow, extra) across this pass's starts, engine-style;
            # ``_select`` asserts it against a fresh recompute (§18).
            # Enabled exactly where the engine batches: count-capped caps
            # (the invariance premise fails under the contiguous cap — see
            # the note in ``_select``) and rigid widths (a moldable
            # dispatch may start wider than the admitted minimum width,
            # overdrawing the carried ``extra`` budget).
            bf = ({} if (mal is None
                         and (self.machine is None
                              or _host.alloc_id(self.alloc)
                              != _host.CONTIGUOUS))
                  else None)
            while True:
                j = self._select(waiting, list(running.values()), free,
                                 cap_now(), clock, bf)
                if j is None:
                    break
                if j.nodes > free:  # preempt policy: suspend victims
                    victims = sorted(
                        (v for v in running.values()
                         if v.priority > j.priority),
                        key=lambda v: (-v.priority, -v.idx))
                    need = j.nodes - free
                    for v in victims:
                        if need <= 0:
                            break
                        need -= v.nodes
                        free += v.nodes
                        v.remaining = max(v.finish - clock, 1)
                        v.finish = -1
                        del running[v.idx]
                        if owner is not None:
                            owner[owner == v.idx] = -1
                        waiting.append(v)
                waiting.remove(j)
                if j.start < 0:
                    j.start = clock   # first dispatch only
                j.last_start = clock  # checkpoint base / rsv shadow key
                if mal is not None:
                    # moldable width choice: among widths that fit the
                    # current capacity, minimize the dilated duration;
                    # first-minimum tie-break → the narrowest such width
                    cap = cap_now()
                    row = m_dur[j.idx]
                    best_k, best_d = 0, None
                    for k in range(m_W):
                        if m_wlo + k <= cap and (best_d is None
                                                 or int(row[k]) < best_d):
                            best_k, best_d = k, int(row[k])
                    if j.prev_w == 0:      # fresh: dur table is exact
                        dilated = int(row[best_k])
                    else:                  # requeued: rescale remaining work
                        dilated = _ratio_ceil_host(
                            j.remaining, int(row[best_k]),
                            int(row[j.prev_w - m_wlo]))
                    j.nodes = m_wlo + best_k
                    j.prev_w = j.nodes
                    j.seg_start = clock
                    j.disp_dur = int(row[best_k])
                else:
                    dilated = j.remaining
                if owner is not None:
                    ids = _host.place_host(self.alloc, mach, owner_view(),
                                           j.nodes)
                    assert down is None or not down[ids].any(), \
                        "placement invariant violated: job on a down node"
                    assert svc_offline is None or not svc_offline[ids].any(), \
                        "placement invariant violated: job on a drained node"
                    owner[ids] = j.idx
                    j.alloc_span = _host.group_span_host(mach, ids)
                    j.alloc_first, j.alloc_sum = _host.fingerprint_host(ids)
                    if mal is None:
                        dilated = _con.dilate_host(alpha_num, alpha_den,
                                                   j.remaining, j.alloc_span)
                j.finish = clock + dilated
                free -= j.nodes
                running[j.idx] = j
                heapq.heappush(heap, (j.finish, j.idx))
                if bf is not None and bf.get("head") is not None:
                    # §18 budget carry: the admission consumed reserve
                    # nodes iff its release entry (clamped time, row)
                    # sorts after the reach entry — a release tie at the
                    # shadow breaks by row, exactly like the rel sort.  An
                    # overdraw (tie corner) moves the reach entry within
                    # its tie group: drop the carry and re-derive.
                    t_c = max(clock + j.estimate, clock + 1)
                    if (t_c, j.idx) > (bf["shadow"], bf["k_idx"]):
                        bf["extra"] -= j.nodes
                        if bf["extra"] < 0:
                            bf.clear()
            if owner is not None:
                ev_time.append(clock)
                ev_free.append(free)
                ev_lfb.append(_host.largest_free_run_host(owner_view()))

        out = {
            "submit": np.array([j.submit for j in jobs], dtype=np.int64),
            "runtime": np.array([j.runtime for j in jobs], dtype=np.int64),
            "nodes": np.array([j.nodes for j in jobs], dtype=np.int64),
            "start": np.array([j.start for j in jobs], dtype=np.int64),
            "finish": np.array([j.finish for j in jobs], dtype=np.int64),
            "ready": np.array(ready, dtype=np.int64),
        }
        out["wait"] = out["start"] - out["ready"]
        out["done"] = out["start"] >= 0
        out["valid"] = np.ones(n, dtype=bool)
        if fail is not None:
            aborted = np.array([j.aborted for j in jobs], dtype=bool)
            out["done"] = out["done"] & ~aborted
            out["aborted"] = aborted
            out["n_restarts"] = np.array(
                [j.n_restarts for j in jobs], dtype=np.int64)
            out["lost_work"] = np.array(
                [j.lost_work for j in jobs], dtype=np.int64)
            out["kill_log"] = kill_log
            out["makespan"] = int(out["finish"][out["done"]].max(initial=0))
        else:
            out["makespan"] = int(out["finish"].max(initial=0))
        out["n_events"] = n_events
        if svc is not None:
            # SLO verdict fixed at start time: met iff the job started by
            # its deadline (deadline rows are input-order; map through the
            # (submit, id) sort like every other job column)
            dl = np.asarray(svc.deadline, dtype=np.int64)[self._order]
            out["deadline"] = dl
            out["slo_met"] = out["done"] & (out["start"] <= dl)
            out["class_id"] = np.asarray(
                svc.class_id, dtype=np.int64)[self._order]
            out["cap_time"] = np.array([t for t, _ in cap_log],
                                       dtype=np.int64)
            out["cap_online"] = np.array([v for _, v in cap_log],
                                         dtype=np.int64)
        if mal is not None:
            # "nodes" reports the ORIGINAL request (engine parity: the
            # engine emits jobs.nodes untouched); the chosen/final width
            # lives in the mal_* columns
            out["nodes"] = np.array(req_nodes, dtype=np.int64)
            out["mal_width"] = np.array([j.nodes for j in jobs],
                                        dtype=np.int64)
            out["mal_nref"] = np.asarray(mal.nref, dtype=np.int64)[:n]
            out["mal_nresize"] = np.array([j.n_resizes for j in jobs],
                                          dtype=np.int64)
            out["mal_node_s"] = np.array([j.node_s for j in jobs],
                                         dtype=np.int64)
            out["mal_dur"] = np.array([j.disp_dur for j in jobs],
                                      dtype=np.int64)
        if mach is not None:
            out["alloc_first"] = np.array(
                [j.alloc_first for j in jobs], dtype=np.int64)
            out["alloc_span"] = np.array(
                [j.alloc_span for j in jobs], dtype=np.int64)
            out["alloc_sum"] = np.array(
                [j.alloc_sum for j in jobs], dtype=np.int64)
            out["ev_time"] = np.array(ev_time, dtype=np.int64)
            out["ev_free"] = np.array(ev_free, dtype=np.int64)
            out["ev_lfb"] = np.array(ev_lfb, dtype=np.int64)
        return out


def simulate_reference(trace, policy: str, *, total_nodes: int, machine=None,
                       alloc: str = "simple", contention=None, failures=None,
                       service=None, malleable=None):
    """One-call host oracle.  ``failures`` is a materialized
    ``reliability.FailureTrace`` (NOT a ``FailureModel``),
    ``service`` a materialized ``serving.ServicePlan`` and
    ``malleable`` a materialized ``malleable.MalleablePlan`` — both
    engines must consume the identical arrays, so materialize once."""
    sim = ReferenceSimulator(total_nodes=total_nodes, policy=policy,
                             machine=machine, alloc=alloc,
                             contention=contention, failures=failures,
                             service=service, malleable=malleable)
    sim.load(trace["submit"], trace["runtime"], trace["nodes"],
             trace.get("estimate"), trace.get("priority"),
             deps=trace.get("deps"))
    return sim.run()


def replay_reference(trace, policy: str = "fcfs", *, total_nodes: int,
                     machine=None, alloc: str = "simple", contention=None,
                     failures=None):
    """Host oracle for streaming (windowed) replay runs.

    Windowed replay is decision-for-decision identical to the one-shot
    schedule (window boundaries never reorder or split an event, DESIGN.md
    §19), so the reference for a streamed trace is simply the reference
    schedule of the *whole* trace.  The trace goes through the replay
    runner's own int64 normalization (``traces.normalize.normalize_trace``)
    — identical input columns on both sides — and the int64 host
    arithmetic here imposes no int32 horizon cap, which makes this the
    oracle for beyond-int32 archives that one-shot ``simulate`` refuses
    outright.
    """
    t = normalize_trace(dict(trace), total_nodes)
    return simulate_reference(t, policy, total_nodes=total_nodes,
                              machine=machine, alloc=alloc,
                              contention=contention, failures=failures)
