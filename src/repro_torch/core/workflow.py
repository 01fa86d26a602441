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
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import jobs as _jobs
from repro_torch.core.jobs import (
    DONE, INF_TIME, RUNNING, WAITING, resolve_device,
)
from repro_torch.kernels.queue_select.ops import queue_select

WF_FCFS = 0
WF_FCFS_FIT = 1
WF_CPATH = 2
WF_POLICY_IDS = {"fcfs": WF_FCFS, "fcfs_fit": WF_FCFS_FIT, "cpath": WF_CPATH}

TASK_FIELDS = ("exec_time", "resources", "valid", "priority", "dep_dst",
               "dep_src")


@dataclasses.dataclass(frozen=True)
class TaskSet:
    """Struct-of-arrays task table of one workflow (paper §3.1).

    Edge ``e`` means task ``dep_dst[e]`` needs task ``dep_src[e]``; the
    edges are in (dst, src) order, without padding.  ``deps`` is the
    reference's dense matrix, for tests; the engine never builds it."""

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
    the device, the clock and the event count on the host."""

    clock: int
    tstate: torch.Tensor   # i32[T] in {WAITING, RUNNING, DONE}
    start: torch.Tensor    # i32[T]
    finish: torch.Tensor   # i32[T]
    free: torch.Tensor     # i32[R] free amount of each resource
    n_events: int


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

class _Run:
    """One ``simulate_workflow`` call: the table, the state, the host's
    copy of the free pools and the dependency counters with their CSR
    bounds."""

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
        self.csr = _jobs.edge_csr(tasks.dep_dst, tasks.dep_src, T)
        self.n_unmet = _jobs.count_deps(
            self.csr, torch.ones(T, dtype=torch.bool, device=dev))

    def _unmet(self) -> torch.Tensor:
        """Each task's count of dependencies not DONE now: the counters, or
        on the plain path a recount (there the reference may start a task
        again after it is DONE, which takes its dependents' readiness back
        as the reference's dense reduction does)."""
        if not self.plain:
            return self.n_unmet
        return _jobs.count_deps(self.csr, self.state.tstate != DONE)

    def select(self) -> int:
        """The task the policy starts next, or -1."""
        st, tasks = self.state, self.tasks
        ready = (st.tstate == WAITING) & (self._unmet() == 0)
        if self.plain:
            return self._select_reference(ready)
        if self.policy == WF_FCFS:
            head = int(queue_select(tasks.priority, ready)[0])
            if head < 0 or (self.res_host[head] > self.free).any():
                return -1
            return head
        fits = torch.all(tasks.resources <= st.free, dim=1)
        return int(queue_select(tasks.priority, ready & fits)[0])

    def _select_reference(self, ready: torch.Tensor) -> int:
        """The reference's two-stage selection, with its ``INF_TIME``
        sentinel, in plain PyTorch."""
        tasks = self.tasks
        fits = torch.all(tasks.resources <= self.state.free, dim=1)
        rows = torch.arange(tasks.capacity, dtype=torch.int32,
                            device=tasks.device)
        prio = torch.where(ready, tasks.priority, INF_TIME)
        cand = ready if self.policy == WF_FCFS else ready & fits
        key = torch.where(cand, prio, INF_TIME)
        pick = torch.argmin(torch.where(cand & (key == key.min()), rows,
                                        INF_TIME))
        if self.policy == WF_FCFS:
            ok = bool(ready.any()) and bool(fits[pick])
        else:
            ok = bool(cand.any())
        return int(pick) if ok else -1

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
            self.n_unmet -= _jobs.count_deps(self.csr, completed)
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
