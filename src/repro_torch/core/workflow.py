"""The standalone multi-resource workflow engine (paper §3) of the PyTorch
port.

Counterpart of ``repro.core.workflow``: tasks draw from abstract resource
pools (cpu, memory, ...; paper Listing 2), and a task is *ready* when it
waits and every dependency is DONE.  To schedule a DAG onto the cluster
(concrete nodes, the six policies, allocation strategies, contention),
lower it with ``repro_torch.traces.workflows.workflow_to_trace`` or a
``WorkflowTrace`` scenario and run the main engine instead (DESIGN.md §13).

Policies:

- ``fcfs``: blocking head of the ready queue (the paper's baseline): the
  ready task of least priority starts if it fits, else nothing starts;
- ``fcfs_fit``: work-conserving: the ready task of least priority among
  those that fit;
- ``cpath``: ``fcfs_fit`` over critical-path priorities (pass
  ``priority=critical_path_length(...)``).

Semantics are the reference's: an initial pass at t = 0 before any event;
each event advances the clock to the next completion, frees the completed
tasks' resources and runs the pass; ``n_events`` counts only those later
events; the loop ends when nothing is RUNNING (a task that never fits
stays WAITING, not done) or at the event cap (default ``T + 8``).

The reference tests readiness with a dense ``T x T`` reduction; the port
keeps the cluster engine's in-degree counters (the same ready set, O(E)
per event).  Each selection is one ``queue_select`` call over the
priorities and the ready mask (and, for ``fcfs_fit``/``cpath``, the fit
mask): the kernel on a CUDA device, its plain version on the CPU.  The
host drives the loop and reads one small tensor per event and one answer
per selection.

``simulate_workflow_ensemble`` runs a stack of workflows
(``stack_tasksets``), each with its own pools and policy, in lockstep: the
counterpart of the reference's ``jax.vmap(simulate_workflow)`` (Fig. 6's
ensemble rows).  Each selection sub-round is one launch of the batched
generic ``queue_select`` entry for every member still selecting, and each
member equals its solo run at the stack's capacity.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core import jobs as _jobs
from repro_torch.core.jobs import (
    DONE, INF_TIME, RUNNING, WAITING, resolve_device,
)
from repro_torch.kernels.queue_select.ops import (
    queue_select, queue_select_batch,
)

WF_FCFS = 0
WF_FCFS_FIT = 1
WF_CPATH = 2
WF_POLICY_IDS = {"fcfs": WF_FCFS, "fcfs_fit": WF_FCFS_FIT, "cpath": WF_CPATH}

TASK_FIELDS = ("exec_time", "resources", "valid", "priority", "dep_dst",
               "dep_src")


@dataclasses.dataclass(frozen=True)
class TaskSet:
    """Struct-of-arrays task table of one workflow (paper §3.1), or of a
    stack of them (``stack_tasksets``: every column gains a leading member
    axis ``B``).

    Edge ``e`` means task ``dep_dst[e]`` needs task ``dep_src[e]``; the
    edges are in (dst, src) order, without padding in a solo table; a
    stack pads each member's list at its end with edges of index
    ``capacity``.  ``deps`` is the reference's dense matrix of a solo
    table, for tests; the engine never builds it."""

    exec_time: torch.Tensor  # i32[T]
    resources: torch.Tensor  # i32[T, R] requirement per resource type
    valid: torch.Tensor      # bool[T]
    priority: torch.Tensor   # i32[T] lower = scheduled earlier
    dep_dst: torch.Tensor    # i32[E] the dependent task
    dep_src: torch.Tensor    # i32[E] the task it needs

    @property
    def capacity(self) -> int:
        return self.exec_time.shape[-1]

    @property
    def n_resources(self) -> int:
        return self.resources.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.exec_time.device

    @property
    def batch(self) -> Optional[int]:
        """The number of members of a stack, ``None`` for a solo table."""
        return None if self.exec_time.dim() == 1 else self.exec_time.shape[0]

    def member(self, b: int) -> "TaskSet":
        """Member ``b`` of a stack as a solo table at the stack's
        capacity, its edge list without the pad edges."""
        n_edges = int((self.host["dep_dst"][b] < self.capacity).sum())
        return TaskSet(**{f: getattr(self, f)[b] for f in TASK_FIELDS[:4]},
                       dep_dst=self.dep_dst[b, :n_edges],
                       dep_src=self.dep_src[b, :n_edges])

    @property
    def deps(self) -> torch.Tensor:
        """Dense ``bool[T, T]``: ``deps[i, j]`` means task i needs task j."""
        T = self.capacity
        dense = torch.zeros((T, T), dtype=torch.bool, device=self.device)
        dense[self.dep_dst.long(), self.dep_src.long()] = True
        return dense

    @functools.cached_property
    def host(self) -> dict:
        return {f: getattr(self, f).cpu().numpy() for f in TASK_FIELDS}

    def to(self, device) -> "TaskSet":
        return TaskSet(**{f: getattr(self, f).to(device)
                          for f in TASK_FIELDS})


@dataclasses.dataclass
class WorkflowState:
    """The pool engine's state, updated in place: the per-task tensors on
    the device, the clock and the event count on the host.  An ensemble's
    state has a leading member axis ``B`` on every tensor and one clock and
    event count a member (lists); ``member(b)`` is member ``b``'s solo
    state."""

    clock: Union[int, List[int]]
    tstate: torch.Tensor   # i32[T] in {WAITING, RUNNING, DONE}
    start: torch.Tensor    # i32[T]
    finish: torch.Tensor   # i32[T]
    free: torch.Tensor     # i32[R] free amount of each resource
    n_events: Union[int, List[int]]

    def member(self, b: int) -> "WorkflowState":
        return WorkflowState(clock=self.clock[b], tstate=self.tstate[b],
                             start=self.start[b], finish=self.finish[b],
                             free=self.free[b], n_events=self.n_events[b])


def make_taskset(exec_time, resources, dep_pairs, *,
                 capacity: int | None = None, priority=None,
                 device=None) -> TaskSet:
    """Build a ``TaskSet`` from host arrays, as the reference does.

    ``dep_pairs`` are (task, dependency) index pairs into ``exec_time``;
    out-of-range pairs, self-dependencies and cycles raise.  Execution
    times are clamped to at least 1; pad rows (up to ``capacity``) run 1,
    need nothing and are invalid; the priority defaults to the row index.
    ``device=None`` means ``cuda``."""
    device = resolve_device(device)
    exec_time = np.maximum(np.asarray(exec_time, dtype=np.int64), 1)
    resources = np.asarray(resources, dtype=np.int64)
    if resources.ndim == 1:
        resources = resources[:, None]
    n = exec_time.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError("capacity < number of tasks")
    dst, src = _jobs.dep_pairs(list(dep_pairs), n)

    res = np.zeros((cap, resources.shape[1]), dtype=np.int32)
    res[:n] = resources.astype(np.int32)
    et = np.full((cap,), 1, dtype=np.int32)
    et[:n] = exec_time.astype(np.int32)
    valid = np.zeros((cap,), dtype=bool)
    valid[:n] = True
    prio = np.arange(cap, dtype=np.int32)
    if priority is not None:
        prio[:n] = np.asarray(priority, dtype=np.int32)
    cols = dict(exec_time=et, resources=res, valid=valid, priority=prio,
                dep_dst=dst.astype(np.int32), dep_src=src.astype(np.int32))
    return TaskSet(**{f: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for f, a in cols.items()})


def stack_tasksets(tasksets) -> TaskSet:
    """Stack solo task tables of one device and one number of resource
    types into one with a leading member axis.

    Members are padded to the largest capacity ``T`` with the rows
    ``make_taskset`` pads with (run 1, need nothing, invalid, priority the
    row index), which are DONE from the start, and their edge lists to the
    longest with inert edges of index ``T`` (as ``parallel.stack_jobsets``
    pads), so no member's schedule changes but for its event cap, which
    ``T`` sets."""
    tasksets = list(tasksets)
    if not tasksets:
        raise ValueError("stack_tasksets needs at least one task table")
    if any(t.batch is not None for t in tasksets):
        raise ValueError("stack_tasksets takes solo tables, not stacks")
    if len({t.device for t in tasksets}) != 1:
        raise ValueError("stack_tasksets needs one device, got "
                         f"{ {t.device for t in tasksets} }")
    n_res = sorted({t.n_resources for t in tasksets})
    if len(n_res) != 1:
        raise ValueError("stack_tasksets needs one number of resource "
                         f"types, got {n_res}")
    T = max(t.capacity for t in tasksets)
    E = max(t.dep_dst.shape[0] for t in tasksets)
    pad = torch.nn.functional.pad

    def stacked(t: TaskSet) -> dict:
        c, e = t.capacity, t.dep_dst.shape[0]
        rows = torch.arange(c, T, dtype=torch.int32, device=t.device)
        return dict(exec_time=pad(t.exec_time, (0, T - c), value=1),
                    resources=pad(t.resources, (0, 0, 0, T - c)),
                    valid=pad(t.valid, (0, T - c), value=False),
                    priority=torch.cat([t.priority, rows]),
                    dep_dst=pad(t.dep_dst, (0, E - e), value=T),
                    dep_src=pad(t.dep_src, (0, E - e), value=T))

    cols = [stacked(t) for t in tasksets]
    return TaskSet(**{f: torch.stack([c[f] for c in cols])
                      for f in TASK_FIELDS})


def critical_path_length(tasks_exec: np.ndarray, dep_pairs) -> np.ndarray:
    """Longest exec-time path from each task to any sink (host-side), as a
    negated priority: a longer critical path gives a lower value, so
    ``cpath`` schedules it earlier."""
    n = len(tasks_exec)
    succ = [[] for _ in range(n)]
    for t, d in dep_pairs:
        succ[d].append(t)           # edge d -> t in execution order
    cp = np.asarray(tasks_exec, dtype=np.int64).copy()
    # reverse-topological order: relax from the sinks
    out_count = np.array([len(s) for s in succ], dtype=np.int64)
    stack = list(np.nonzero(out_count == 0)[0])
    pred = [[] for _ in range(n)]
    for t, d in dep_pairs:
        pred[t].append(d)
    remaining = out_count.copy()
    while stack:
        t = stack.pop()
        for d in pred[t]:
            cp[d] = max(cp[d], tasks_exec[d] + cp[t])
            remaining[d] -= 1
            if remaining[d] == 0:
                stack.append(d)
    return (-cp).astype(np.int32)


# ---------------------------------------------------------------------------
# event engine
# ---------------------------------------------------------------------------

def _select_reference(policy: int, priority: torch.Tensor,
                      resources: torch.Tensor, free: torch.Tensor,
                      ready: torch.Tensor) -> int:
    """The reference's two-stage selection over one table, with its
    ``INF_TIME`` sentinel, in plain PyTorch: the task it starts next, or
    -1."""
    fits = torch.all(resources <= free, dim=1)
    rows = torch.arange(priority.shape[0], dtype=torch.int32,
                        device=priority.device)
    prio = torch.where(ready, priority, INF_TIME)
    cand = ready if policy == WF_FCFS else ready & fits
    key = torch.where(cand, prio, INF_TIME)
    pick = torch.argmin(torch.where(cand & (key == key.min()), rows,
                                    INF_TIME))
    if policy == WF_FCFS:
        ok = bool(ready.any()) and bool(fits[pick])
    else:
        ok = bool(cand.any())
    return int(pick) if ok else -1


class _Run:
    """One ``simulate_workflow`` call: the table, the state, the host's
    copy of the free pools and the dependency counters with their edge
    list."""

    def __init__(self, tasks: TaskSet, pools, policy: int):
        T, dev = tasks.capacity, tasks.device
        self.tasks, self.policy = tasks, policy
        self.res_host = tasks.host["resources"]
        self.et_host = tasks.host["exec_time"]
        free = [int(v) for v in np.asarray(pools).reshape(-1)]
        inf = torch.full((T,), INF_TIME, dtype=torch.int32, device=dev)
        self.state = WorkflowState(
            clock=0,
            tstate=torch.where(tasks.valid, WAITING, DONE).to(torch.int32),
            start=inf, finish=inf.clone(),
            free=torch.tensor(free, dtype=torch.int32).to(dev), n_events=0)
        self.free = np.asarray(free, dtype=np.int64)
        self.n_running = 0
        # the reference's masked minimum where(ready, priority, INF_TIME)
        # differs from the true one when a priority reaches INF_TIME; such
        # a table takes the reference's form in plain PyTorch (ROADMAP
        # Queue 3)
        self.plain = bool((tasks.priority >= INF_TIME).any())
        self.deps = _jobs.edge_list(tasks.dep_dst, tasks.dep_src, T)
        self.n_unmet = _jobs.count_deps(
            self.deps, torch.ones(T, dtype=torch.bool, device=dev))

    def _unmet(self) -> torch.Tensor:
        """Each task's count of dependencies not DONE now: the counters, or
        on the plain path a recount (there the reference may start a task
        again after it is DONE, which takes its dependents' readiness back
        as the reference's dense reduction does)."""
        if not self.plain:
            return self.n_unmet
        return _jobs.count_deps(self.deps, self.state.tstate != DONE)

    def select(self) -> int:
        """The task the policy starts next, or -1."""
        st, tasks = self.state, self.tasks
        ready = (st.tstate == WAITING) & (self._unmet() == 0)
        if self.plain:
            return _select_reference(self.policy, tasks.priority,
                                     tasks.resources, st.free, ready)
        if self.policy == WF_FCFS:
            head = int(queue_select(tasks.priority, ready)[0])
            if head < 0 or (self.res_host[head] > self.free).any():
                return -1
            return head
        fits = torch.all(tasks.resources <= st.free, dim=1)
        return int(queue_select(tasks.priority, ready & fits)[0])

    def start(self, idx: int) -> None:
        st, clock = self.state, self.state.clock
        st.tstate[idx] = RUNNING
        st.start[idx] = clock
        st.finish[idx] = clock + int(self.et_host[idx])
        st.free -= self.tasks.resources[idx]
        self.free -= self.res_host[idx]
        self.n_running += 1

    def schedule(self) -> None:
        idx = self.select()
        while idx >= 0:
            self.start(idx)
            idx = self.select()

    def event(self) -> None:
        """Advance to the next completion, free the completed tasks'
        resources, release their dependents and run the pass; one read."""
        st, tasks = self.state, self.tasks
        running = st.tstate == RUNNING
        clock = torch.min(torch.where(running, st.finish, INF_TIME))
        completed = running & (st.finish <= clock)
        freed = torch.sum(torch.where(completed[:, None], tasks.resources, 0),
                          dim=0, dtype=torch.int32)
        st.tstate = torch.where(completed, DONE, st.tstate).to(torch.int32)
        if not self.plain:
            self.n_unmet -= _jobs.count_deps(self.deps, completed)
        st.free += freed
        clock, n_completed, *got = torch.cat(
            [clock[None], torch.sum(completed, dtype=torch.int32)[None],
             freed]).tolist()
        st.clock = clock
        st.n_events += 1
        self.free += np.asarray(got, dtype=np.int64)
        self.n_running -= n_completed
        self.schedule()


def simulate_workflow(tasks: TaskSet, pools, policy=WF_FCFS, *,
                      max_events: Optional[int] = None,
                      device=None) -> WorkflowState:
    """Simulate one workflow on the resource pools ``pools`` (``[R]``).

    ``policy`` is an id of ``WF_POLICY_IDS`` or its name (ids clamp to
    0..2, as in the reference).  ``device=None`` runs on ``cuda`` (and
    raises without one); the table moves there if it lies elsewhere."""
    device = resolve_device(device)
    if tasks.device != device:
        tasks = tasks.to(device)
    if isinstance(policy, str):
        policy = WF_POLICY_IDS[policy]
    run = _Run(tasks, pools, min(max(int(policy), 0), 2))
    cap = max_events if max_events is not None else tasks.capacity + 8
    run.schedule()        # the initial pass at t = 0: every root is ready
    while run.n_running > 0 and run.state.n_events < cap:
        run.event()
    return run.state


class _BatchRun:
    """One ``simulate_workflow_ensemble`` call: the stacked table, the
    batched state, each member's host copy of its free pools and running
    count, and the dependency counters of every member as one edge list
    over the ``B x T`` rows (member ``b``'s rows offset by ``b * T``)."""

    def __init__(self, tasks: TaskSet, pools, policies):
        B, T, dev = tasks.batch, tasks.capacity, tasks.device
        self.tasks, self.policy = tasks, policies
        h = tasks.host
        self.res_host, self.et_host = h["resources"], h["exec_time"]
        self.free = np.array(pools, dtype=np.int64)
        inf = torch.full((B, T), INF_TIME, dtype=torch.int32, device=dev)
        self.state = WorkflowState(
            clock=[0] * B,
            tstate=torch.where(tasks.valid, WAITING, DONE).to(torch.int32),
            start=inf, finish=inf.clone(),
            free=torch.from_numpy(self.free.astype(np.int32)).to(dev),
            n_events=[0] * B)
        self.n_running = [0] * B
        # a member whose priorities reach INF_TIME selects in the
        # reference's two-stage form, as the solo engine does
        self.plain = (h["priority"] >= INF_TIME).any(axis=1).tolist()
        self.blocking = torch.tensor(
            [p == WF_FCFS for p in policies]).to(dev)[:, None]
        real = h["dep_dst"] < T
        offset = (np.arange(B, dtype=np.int64) * T)[:, None]
        dst = torch.from_numpy((h["dep_dst"] + offset)[real]).to(dev)
        src = torch.from_numpy((h["dep_src"] + offset)[real]).to(dev)
        self.deps = _jobs.edge_list(dst, src, B * T)
        self.n_unmet = _jobs.count_deps(
            self.deps, torch.ones(B * T, dtype=torch.bool, device=dev)
        ).view(B, T)

    def select(self, members: list) -> list:
        """The task each member starts next (-1 for none), in order:
        one batched launch for the members on the kernel."""
        st, tasks = self.state, self.tasks
        ready = (st.tstate == WAITING) & (self.n_unmet == 0)
        kernel = [b for b in members if not self.plain[b]]
        picks = dict.fromkeys(members, -1)
        if kernel:
            # fcfs takes the ready head and checks its fit on the host
            fits = torch.all(tasks.resources <= st.free[:, None, :], dim=2)
            feasible = ready & (fits | self.blocking)
            for b, (idx, _) in zip(kernel, queue_select_batch(
                    tasks.priority, feasible, kernel)):
                if (idx >= 0 and self.policy[b] == WF_FCFS
                        and (self.res_host[b, idx] > self.free[b]).any()):
                    idx = -1
                picks[b] = idx
        plain = [b for b in members if self.plain[b]]
        if plain:
            # the reference's form, with a recount of the dependencies not
            # DONE, as the solo engine's plain path (_Run._unmet)
            unmet = _jobs.count_deps(
                self.deps, (st.tstate != DONE).reshape(-1)).view_as(ready)
            for b in plain:
                picks[b] = _select_reference(
                    self.policy[b], tasks.priority[b], tasks.resources[b],
                    st.free[b], (st.tstate[b] == WAITING) & (unmet[b] == 0))
        return [picks[b] for b in members]

    def start(self, starts: list) -> None:
        """Start task ``idx`` of member ``b`` for each ``(b, idx)``, at most
        one a member: one upload and one indexed write of each column."""
        st = self.state
        cols = [(b, idx, st.clock[b], st.clock[b] + int(self.et_host[b, idx]))
                for b, idx in starts]
        b_t, i_t, clock, finish = torch.tensor(
            cols, dtype=torch.int64).to(self.tasks.device).unbind(1)
        st.tstate[b_t, i_t] = RUNNING
        st.start[b_t, i_t] = clock.to(torch.int32)
        st.finish[b_t, i_t] = finish.to(torch.int32)
        st.free[b_t] -= self.tasks.resources[b_t, i_t]
        for b, idx in starts:
            self.free[b] -= self.res_host[b, idx]
            self.n_running[b] += 1

    def schedule(self, members: list) -> None:
        """The pass of each member of ``members``: selection sub-rounds in
        lockstep until no member starts a task."""
        while members:
            starts = [(b, idx) for b, idx in zip(members,
                                                 self.select(members))
                      if idx >= 0]
            if starts:
                self.start(starts)
            members = [b for b, _ in starts]

    def event(self, members: list) -> None:
        """The next completion event of each member of ``members``, whose
        completed tasks free their resources and release their dependents,
        then the members' passes; one read.  A member outside ``members``
        keeps its state."""
        st, tasks = self.state, self.tasks
        B = tasks.batch
        running = st.tstate == RUNNING
        clock = torch.min(torch.where(running, st.finish, INF_TIME),
                          dim=1).values
        completed = running & (st.finish <= clock[:, None])
        active = set(members)
        if any(n > 0 and b not in active
               for b, n in enumerate(self.n_running)):
            # a member at its event cap with tasks running stays as it is
            keep = torch.tensor([b in active for b in range(B)])
            completed &= keep.to(tasks.device)[:, None]
        freed = torch.sum(torch.where(completed[..., None], tasks.resources,
                                      0), dim=1, dtype=torch.int32)
        st.tstate = torch.where(completed, DONE, st.tstate).to(torch.int32)
        self.n_unmet -= _jobs.count_deps(
            self.deps, completed.reshape(-1)).view_as(self.n_unmet)
        st.free += freed
        got = torch.cat([clock, torch.sum(completed, dim=1,
                                          dtype=torch.int32),
                         freed.reshape(-1)]).tolist()
        R = tasks.n_resources
        for b in members:
            st.clock[b] = got[b]
            st.n_events[b] += 1
            self.n_running[b] -= got[B + b]
            self.free[b] += got[2 * B + b * R:2 * B + (b + 1) * R]
        self.schedule(members)


def simulate_workflow_ensemble(tasks_b: TaskSet, pools_b, policies_b, *,
                               max_events: Optional[int] = None,
                               device=None) -> WorkflowState:
    """Simulate the members of a stacked table (``stack_tasksets``) in
    lockstep, member ``b`` on the pools ``pools_b[b]`` under the policy
    ``policies_b[b]`` (``[B, R]`` and ``[B]``; one ``[R]`` pool vector or
    one policy serves every member), as ``jax.vmap(simulate_workflow)``
    does in the reference.

    Every member takes the initial pass at t = 0; then each runs while it
    has a task running and fewer than ``max_events`` events (default ``T +
    8`` of the stack's capacity ``T``, for every member).  A selection
    sub-round is one batched ``queue_select`` launch for the members still
    selecting; a member that has stopped keeps its state.  Returns the
    batched ``WorkflowState``; ``state.member(b)`` equals
    ``simulate_workflow(tasks_b.member(b), pools_b[b], policies_b[b])``.
    ``device=None`` runs on ``cuda`` (and raises without one)."""
    device = resolve_device(device)
    if tasks_b.batch is None:
        raise ValueError("simulate_workflow_ensemble takes a stacked table "
                         "(stack_tasksets); run a solo one with "
                         "simulate_workflow")
    if tasks_b.device != device:
        tasks_b = tasks_b.to(device)
    B = tasks_b.batch
    if isinstance(policies_b, (str, int)):
        policies_b = [policies_b] * B
    policies = [min(max(int(WF_POLICY_IDS[p] if isinstance(p, str) else p),
                        0), 2) for p in policies_b]
    if len(policies) != B:
        raise ValueError(f"{len(policies)} policies for {B} members")
    pools = np.broadcast_to(np.asarray(pools_b, dtype=np.int64),
                            (B, tasks_b.n_resources))
    run = _BatchRun(tasks_b, pools, policies)
    cap = max_events if max_events is not None else tasks_b.capacity + 8
    run.schedule(list(range(B)))   # the initial pass at t = 0
    while True:
        members = [b for b in range(B) if run.n_running[b] > 0
                   and run.state.n_events[b] < cap]
        if not members:
            return run.state
        run.event(members)


def workflow_result_np(tasks: TaskSet, state: WorkflowState) -> dict:
    """The reference's result dict: per-task ``start``, ``finish``,
    ``ready`` (the latest dependency finish, 0 for a root, ``INF_TIME``
    where a dependency never finished) and ``wait = start - ready``, with
    ``done``, ``valid``, ``makespan`` and ``n_events``."""
    h = tasks.host
    valid = h["valid"]
    start = state.start.cpu().numpy()
    finish = state.finish.cpu().numpy()
    done = state.tstate.cpu().numpy() == DONE
    ready = np.zeros(tasks.capacity, dtype=np.int32)
    np.maximum.at(ready, h["dep_dst"], finish[h["dep_src"]])
    return {
        "exec_time": h["exec_time"],
        "start": start,
        "finish": finish,
        "ready": ready,
        "wait": np.where(valid, start - ready, 0),
        "done": done & valid,
        "valid": valid,
        "makespan": int(finish[valid & done].max(initial=0)),
        "n_events": int(state.n_events),
    }
