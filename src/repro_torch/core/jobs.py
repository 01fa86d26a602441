"""Job table and simulation state of the PyTorch engine.

Counterpart of ``repro.core.jobs``.  The job table is a struct of int32
tensors sorted by (submit, id); ``SimState`` holds the per-job state
tensors plus the scalars the host-driven event loop reads on every event
(``clock``, ``free``, ``n_events``), which live on the host as Python ints.
Per-job times and counts are ``torch.int32`` with the sentinel ``INF_TIME =
2**30 - 1``, as in the reference.

With a machine (topology-aware allocation, DESIGN.md §11) the state also
carries the per-node occupancy map ``node_owner`` on the device, each job's
allocation fingerprint (``alloc_first``/``alloc_span``/``alloc_sum``) and
the per-event fragmentation log (``ev_time``/``ev_free``/``ev_lfb``), with
the reference's initial values and lengths.

An ensemble stacks B tables of one capacity into a ``JobSet`` whose
columns are ``[B, J]`` (``core.parallel.stack_jobsets``), as the
reference's ``stack_jobsets`` stacks its pytree: a member's row is a
contiguous view, so ``JobSet.member(b)`` is the solo table of member ``b``
without a copy.  ``EnsembleState`` holds the per-job state as ``[B, J]``
tensors and each member's scalars on the host.

Dependency edges (paper §3, DESIGN.md §13-§14) are the reference's padded
edge list: ``JobSet.dep_dst``/``dep_src`` in dst-ascending order, pad slots
holding the index ``capacity``, ``None`` for a table without edges; the
state carries the in-degree counters ``n_unmet`` (``None`` without edges)
and a result's ``ready`` is ``max(submit, last dependency's finish)``.  A
pad index is never used as one: the engine keeps pad edges out by a
``J + 1`` buffer whose last slot is cut off (:func:`count_deps`).

With a failure stream (DESIGN.md §15) the state carries ``rel``
(:class:`RelState`: each job's latest start, restarts, lost work and abort
flag, and the down-node mask), with a service plan (§16) ``svc``
(:class:`SvcState`: the online count, the offline-node mask and the
capacity log); each is ``None`` when its source is off, and the result
carries their columns (:class:`FailureInfo`, :class:`SvcInfo`).

With a malleable plan (DESIGN.md §17) the state carries ``mal``
(:class:`MalState`): each job's current width (its node footprint, which
every fit check, release and demand reads in place of ``nodes``), on the
device and mirrored on the host, and the node-second ledger; the result
carries its columns (:class:`MalInfo`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.queue_select import ops as select_ops

# Job lifecycle states.
PENDING = 0   # submit time is in the future
WAITING = 1   # in the wait queue
RUNNING = 2   # allocated nodes, executing
DONE = 3      # completed; resources reclaimed

# Sentinel "infinite" time, kept well under int32 max so that sentinel
# arithmetic (e.g. INF + estimate) cannot wrap.
INF_TIME = 2**30 - 1

# Scheduling policies.
FCFS = 0
SJF = 1
LJF = 2
BESTFIT = 3
BACKFILL = 4
PREEMPT = 5

POLICY_NAMES = {
    FCFS: "fcfs",
    SJF: "sjf",
    LJF: "ljf",
    BESTFIT: "bestfit",
    BACKFILL: "backfill",
    PREEMPT: "preempt",
}
POLICY_IDS = {v: k for k, v in POLICY_NAMES.items()}

JOB_COLUMNS = ("submit", "runtime", "estimate", "nodes", "priority", "valid")
EDGE_FIELDS = ("dep_dst", "dep_src")
JOB_FIELDS = JOB_COLUMNS + EDGE_FIELDS
STATE_TENSORS = ("jstate", "start", "finish", "rsv_finish", "remaining")
STATE_SCALARS = ("clock", "free", "n_events")
ALLOC_FIELDS = ("alloc_first", "alloc_span", "alloc_sum")
EV_FIELDS = ("ev_time", "ev_free", "ev_lfb")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Without a CUDA device the default raises instead of running
    on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class JobSet:
    """Immutable struct-of-arrays job table, sorted by (submit, id).

    ``valid`` masks padding rows.  ``estimate`` is the user's walltime
    request (SJF/LJF order, EASY reservations); ``runtime`` the actual
    duration.  Edge ``e`` of ``dep_dst``/``dep_src`` means job
    ``dep_dst[e]`` cannot enter the wait queue before job ``dep_src[e]`` is
    DONE; both are ``None`` for a table without edges.  ``host`` is a numpy
    copy the event loop reads single rows from without a device round
    trip; ``selector`` the fused selections (the ``queue_select`` kernels)
    over this table.
    """

    submit: torch.Tensor    # i32[J]
    runtime: torch.Tensor   # i32[J] actual duration, >= 1
    estimate: torch.Tensor  # i32[J] requested walltime, >= 1
    nodes: torch.Tensor     # i32[J] requested nodes, >= 1
    priority: torch.Tensor  # i32[J] lower = more important (preempt)
    valid: torch.Tensor     # bool[J]
    dep_dst: Optional[torch.Tensor] = None  # i32[E] dependent row (pad: J)
    dep_src: Optional[torch.Tensor] = None  # i32[E] dependency row (pad: J)

    @property
    def capacity(self) -> int:
        return self.submit.shape[-1]

    @property
    def edge_capacity(self) -> int:
        """Padded edge-list length (0 when the table carries no edges)."""
        return 0 if self.dep_dst is None else self.dep_dst.shape[-1]

    @property
    def deps(self) -> Optional[torch.Tensor]:
        """Dense ``bool[J, J]`` of the edge list (``None`` without edges),
        for tests on a solo table; the engine never builds it."""
        if self.dep_dst is None:
            return None
        if self.dep_dst.dim() != 1:
            raise ValueError("JobSet.deps is built for solo tables only; "
                             "take a member of the stack first")
        J = self.capacity
        dense = torch.zeros((J + 1, J + 1), dtype=torch.bool,
                            device=self.device)
        dense[self.dep_dst.long(), self.dep_src.long()] = True
        return dense[:J, :J]

    def _map(self, fn) -> "JobSet":
        return JobSet(**{f: None if getattr(self, f) is None
                         else fn(getattr(self, f)) for f in JOB_FIELDS})

    @property
    def batch(self) -> int | None:
        """B for a stacked table (``[B, J]`` columns), None for a solo one."""
        return self.submit.shape[0] if self.submit.dim() == 2 else None

    def member(self, b: int) -> "JobSet":
        """Member ``b`` of a stacked table: its rows, as views."""
        return self._map(lambda t: t[b])

    @property
    def device(self) -> torch.device:
        return self.submit.device

    @functools.cached_property
    def host(self) -> dict:
        return {f: getattr(self, f).cpu().numpy() for f in JOB_FIELDS
                if getattr(self, f) is not None}

    @functools.cached_property
    def selector(self):
        """``TableSelect`` over a solo table, ``BatchedTableSelect`` over a
        stacked one."""
        cols = {f: getattr(self, f) for f in select_ops.COLUMNS}
        if self.batch is None:
            return select_ops.TableSelect(cols)
        return select_ops.BatchedTableSelect(cols)

    def to(self, device) -> "JobSet":
        return self._map(lambda t: t.to(device))


def _acyclic_pairs(n: int, dst: np.ndarray, src: np.ndarray) -> None:
    """Kahn's algorithm over the pairs (``dst[e]`` depends on ``src[e]``,
    no duplicates) of an ``n``-node graph; raises on a cycle."""
    indeg = np.bincount(dst, minlength=n)
    order = np.argsort(src, kind="stable")
    starts = np.searchsorted(src[order], np.arange(n + 1))
    succ = dst[order]
    stack = list(np.nonzero(indeg == 0)[0])
    seen = 0
    while stack:
        j = stack.pop()
        seen += 1
        for i in succ[starts[j]:starts[j + 1]]:
            indeg[i] -= 1
            if indeg[i] == 0:
                stack.append(i)
    if seen != n:
        raise ValueError("dependency graph contains a cycle")


def assert_acyclic(deps: np.ndarray) -> None:
    """Raise on a cycle of a dense bool dependency matrix (``deps[i, j]``:
    *i* depends on *j*), as the reference's ``assert_acyclic``."""
    dst, src = np.nonzero(np.asarray(deps))
    _acyclic_pairs(np.asarray(deps).shape[0], dst, src)


def dep_pairs(deps, n: int) -> tuple:
    """Normalize ``deps`` (a pair list or a dense matrix, input indices) to
    validated, duplicate-free ``(dst, src)`` int64 arrays in (dst, src)
    order, with the reference's ``_dense_deps`` rules and errors: a bool
    2-D array is always a dense matrix (a wrong shape is an error), other
    2-D arrays are a matrix only at the exact ``(n, n)`` shape, else a
    ``(job, dependency)`` pair list; pairs are checked in order (range,
    then self-dependency), then the graph for cycles.  No ``n x n`` matrix
    is built for a pair list."""
    mat = np.asarray(deps) if not isinstance(deps, (list, tuple)) else None
    is_dense = (mat is not None and mat.ndim == 2 and mat.dtype != object
                and (mat.dtype == bool or mat.shape == (n, n)))
    if is_dense:
        if mat.shape != (n, n):
            raise ValueError(
                f"dense deps matrix has shape {mat.shape}, expected ({n}, {n})")
        dense = mat.astype(bool)
        if dense.diagonal().any():
            raise ValueError("self-dependency")
        dst, src = np.nonzero(dense)
    else:
        pairs = np.array([(int(p[0]), int(p[1])) for p in deps],
                         dtype=np.int64).reshape(-1, 2)
        dst, src = pairs[:, 0], pairs[:, 1]
        bad_range = (dst < 0) | (dst >= n) | (src < 0) | (src >= n)
        bad = bad_range | (dst == src)
        if bad.any():
            e = int(np.argmax(bad))
            if bad_range[e]:
                raise ValueError(f"dependency pair ({dst[e]},{src[e]}) out "
                                 "of range")
            raise ValueError("self-dependency")
        key = np.unique(dst * n + src)
        dst, src = key // n, key % n
    _acyclic_pairs(n, dst, src)
    return dst.astype(np.int64), src.astype(np.int64)


# Edge-list pads round up to this multiple, as in the reference
_EDGE_ALIGN = 64


def dep_edge_arrays(deps, n: int, order: np.ndarray) -> tuple:
    """``deps`` as ``(dst, src)`` index arrays in sorted-row coordinates
    (row ``r`` is input job ``order[r]``), in (dst, src) lexicographic
    order: the reference's ``dep_edge_arrays``, by a sort of the permuted
    pairs in place of a dense ``n x n`` matrix."""
    dst, src = dep_pairs(deps, n)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    dst, src = inv[dst], inv[src]
    o = np.lexsort((src, dst))
    return dst[o], src[o]


def make_jobset(
    submit,
    runtime,
    nodes,
    estimate=None,
    priority=None,
    *,
    deps=None,
    capacity: int | None = None,
    edge_capacity: int | None = None,
    total_nodes: int | None = None,
    device=None,
) -> JobSet:
    """Build a normalized ``JobSet`` from host arrays.

    The same normalization as the reference: sort by (submit, original
    index), clamp node requests to ``total_nodes``, pad to ``capacity``
    with invalid rows, and refuse a horizon that would overflow the int32
    sentinel.  ``deps`` (``(job, dependency)`` pairs or a dense bool
    matrix, in input order) is cycle-checked, permuted into row order and
    lowered to the padded edge list (dst-ascending, length rounded up to a
    multiple of 64 or exactly ``edge_capacity``, pad slots holding
    ``capacity``); an empty or all-False ``deps`` gives ``None``.
    ``device=None`` means ``cuda``.
    """
    device = resolve_device(device)
    submit = np.asarray(submit, dtype=np.int64)
    runtime = np.asarray(runtime, dtype=np.int64)
    nodes = np.asarray(nodes, dtype=np.int64)
    estimate = (np.asarray(estimate, dtype=np.int64) if estimate is not None
                else runtime.copy())
    n = submit.shape[0]
    priority = (np.asarray(priority, dtype=np.int64) if priority is not None
                else np.zeros(n, dtype=np.int64))
    if not (runtime.shape[0] == nodes.shape[0] == estimate.shape[0] == n):
        raise ValueError("job attribute arrays must have equal length")

    submit = submit - (submit.min() if n else 0)
    runtime = np.maximum(runtime, 1)
    estimate = np.maximum(estimate, 1)
    nodes = np.maximum(nodes, 1)
    if total_nodes is not None:
        nodes = np.minimum(nodes, total_nodes)

    horizon = submit.max(initial=0) + 2 * max(int(runtime.max(initial=1)),
                                              int(estimate.max(initial=1)))
    if horizon >= INF_TIME:
        raise ValueError(
            f"trace horizon {horizon} overflows int32 sentinel; rescale the "
            "trace")

    order = np.lexsort((np.arange(n), submit))
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < number of jobs {n}")

    edges = {}
    if deps is not None:
        dst, src = dep_edge_arrays(deps, n, order)
        n_edges = int(dst.size)
        if n_edges:
            if edge_capacity is None:
                ecap = -(-n_edges // _EDGE_ALIGN) * _EDGE_ALIGN
            else:
                ecap = int(edge_capacity)
                if ecap < n_edges:
                    raise ValueError(
                        f"edge_capacity {ecap} < number of edges {n_edges}")
            for f, a in zip(EDGE_FIELDS, (dst, src)):
                out = np.full((ecap,), cap, dtype=np.int32)
                out[:n_edges] = a
                edges[f] = torch.from_numpy(out).to(device)

    def pad(a, fill):
        out = np.full((cap,), fill, dtype=np.int32)
        out[:n] = a[order].astype(np.int32)
        return torch.from_numpy(out).to(device)

    valid = np.zeros((cap,), dtype=bool)
    valid[:n] = True
    return JobSet(
        submit=pad(submit, INF_TIME),
        runtime=pad(runtime, 1),
        estimate=pad(estimate, 1),
        nodes=pad(nodes, 1),
        priority=pad(priority, 0),
        valid=torch.from_numpy(valid).to(device),
        **edges,
    )


class DepList(NamedTuple):
    """The release structure of an edge list in any order: a multicluster
    import neutralizes the edges of its landing rows in the middle of the
    list (both endpoints to the pad index ``J``), so the list may lose its
    dst order.  ``dst`` (i64 ``[..., E]``, pads ``J``) and ``src`` (i64,
    clamped into the table); counts scatter-add into a ``J + 1`` buffer
    whose last slot takes the pad edges and is cut off."""

    dst: torch.Tensor
    src: torch.Tensor


def edge_list(dep_dst: torch.Tensor, dep_src: torch.Tensor, J: int
              ) -> DepList:
    """The :class:`DepList` of an edge list over ``J`` rows."""
    return DepList(dep_dst.long(), dep_src.long().clamp(max=max(J - 1, 0)))


def count_deps(deps: DepList, flags: torch.Tensor) -> torch.Tensor:
    """Each row's count of dependencies whose flag is set (``flags``:
    bool ``[..., J]``), i32 ``[..., J]``: a scatter-add of the flags
    gathered along the edge list by ``dst`` (the reference window's
    release; integer counts, so equal in any edge order)."""
    J = flags.shape[-1]
    out = torch.zeros((*flags.shape[:-1], J + 1), dtype=torch.int32,
                      device=flags.device)
    out.scatter_add_(-1, deps.dst, torch.gather(flags, -1, deps.src).to(
        torch.int32))
    return out[..., :J]


def in_degrees(jobs: JobSet) -> Optional[torch.Tensor]:
    """Each job's count of dependencies (``n_unmet`` at the start), i32
    ``[J]`` or ``[B, J]``, or ``None`` for a table without edges; a
    scatter-add, so it holds in any edge order."""
    if jobs.dep_dst is None:
        return None
    return count_deps(edge_list(jobs.dep_dst, jobs.dep_src, jobs.capacity),
                      torch.ones_like(jobs.valid))


def dependency_finish(jobs: JobSet, finish: torch.Tensor) -> torch.Tensor:
    """Each job's latest dependency finish (0 without one), ``[..., J]``:
    the reference's scatter-max of ``finish[dep_src]`` over ``dep_dst``,
    with pad edges reading and writing a slot ``J`` that is cut off."""
    J = jobs.capacity
    ext = torch.zeros((*finish.shape[:-1], J + 1), dtype=finish.dtype,
                      device=finish.device)
    src_fin = torch.gather(torch.cat([finish, ext[..., :1]], -1), -1,
                           jobs.dep_src.long())
    return ext.scatter_reduce_(-1, jobs.dep_dst.long(), src_fin, "amax",
                               include_self=True)[..., :J]


def machine_fields(J: int, N: int, L: int, device, batch=()) -> dict:
    """The allocation fields' initial values, as in the reference: a free
    map of ``N`` nodes, nothing placed (``alloc``: i32[..., 3, J], the rows
    of ``alloc_first`` at -1, ``alloc_span`` and ``alloc_sum`` at 0,
    written together at a start), an empty log of ``L`` events.  ``N`` and
    ``L`` are 0 without a machine."""
    alloc = torch.zeros(*batch, 3, J, dtype=torch.int32, device=device)
    alloc[..., 0, :] = -1
    return dict(
        node_owner=torch.full((*batch, N), -1, dtype=torch.int32,
                              device=device),
        alloc=alloc,
        ev_time=np.full((*batch, L), -1, dtype=np.int32),
        ev_free=np.zeros((*batch, L), dtype=np.int32),
        ev_lfb=torch.zeros((*batch, L), dtype=torch.int32, device=device))


class _AllocViews:
    """``alloc_first``, ``alloc_span`` and ``alloc_sum`` as views of the
    ``alloc`` block."""

    @property
    def alloc_first(self) -> torch.Tensor:
        return self.alloc[..., 0, :]

    @property
    def alloc_span(self) -> torch.Tensor:
        return self.alloc[..., 1, :]

    @property
    def alloc_sum(self) -> torch.Tensor:
        return self.alloc[..., 2, :]


@dataclasses.dataclass
class RelState:
    """Reliability state (DESIGN.md §15) of a run with a failure stream.

    The host keeps each member's stream (``ctx``: a ``FailCtx``) and its
    pointer to the next unconsumed entry (``ptr``), and, on a machine, a
    copy of the down mask (``down_host``), so a repair needs no read.  The
    per-job columns are ``[..., J]`` on the device: the clock of the
    latest start (the checkpoint base), the requeue kills survived, the
    work charged (rework and overhead, or the aborted work) and the abort
    flag.  ``down`` is the device down mask ``[..., N]`` (``N`` = 0
    without a machine).  A solo run's lists have one entry."""

    ctx: list
    ptr: list
    last_start: torch.Tensor   # i32[..., J]
    n_restarts: torch.Tensor   # i32[..., J]
    lost_work: torch.Tensor    # i32[..., J]
    aborted: torch.Tensor      # bool[..., J]
    down: torch.Tensor         # bool[..., N]
    down_host: np.ndarray      # bool[..., N]

    @classmethod
    def init(cls, ctxs, J: int, N: int, device, batch=()) -> "RelState":
        zeros = torch.zeros((*batch, J), dtype=torch.int32, device=device)
        return cls(ctx=list(ctxs), ptr=[0] * len(ctxs), last_start=zeros,
                   n_restarts=zeros.clone(), lost_work=zeros.clone(),
                   aborted=torch.zeros((*batch, J), dtype=torch.bool,
                                       device=device),
                   down=torch.zeros((*batch, N), dtype=torch.bool,
                                    device=device),
                   down_host=np.zeros((*batch, N), dtype=bool))


@dataclasses.dataclass
class SvcState:
    """Serving state (DESIGN.md §16) of a run with a service plan.

    The host keeps each member's plan (``ctx``: a ``SvcCtx``), its pointer
    to the next autoscaler tick (``ptr``), its online node count
    (``n_online``) and the capacity log (``cap_online``, ``[..., T]``, the
    online count after each consumed tick, -1 where none was).  On a
    machine ``offline`` is the device mask of the scaled-out nodes
    ``[..., N]`` (``N`` = 0 without one).  ``deadline`` is the plan's
    deadline column on the device.  A solo run's lists have one entry."""

    ctx: list
    ptr: list
    n_online: list
    offline: torch.Tensor      # bool[..., N]
    cap_online: np.ndarray     # i32[..., T]
    deadline: torch.Tensor     # i32[..., J]

    @classmethod
    def init(cls, ctxs, total_nodes, N: int, device, batch=()) -> "SvcState":
        T = ctxs[0].tick_time.shape[-1]
        deadline = np.stack([c.deadline for c in ctxs])
        return cls(ctx=list(ctxs), ptr=[0] * len(ctxs),
                   n_online=[int(t) for t in total_nodes],
                   offline=torch.zeros((*batch, N), dtype=torch.bool,
                                       device=device),
                   cap_online=np.full((*batch, T), -1, dtype=np.int32),
                   deadline=torch.from_numpy(
                       deadline if batch else deadline[0]).to(device))


@dataclasses.dataclass
class MalState:
    """Malleability state (DESIGN.md §17) of a run with a malleable plan.

    The host keeps each member's plan (``ctx``: a ``MalCtx``) and its
    pointer to the next resize tick (``ptr``).  ``width`` is each job's
    current width on the device (``min_width`` while it waits, the width
    chosen at dispatch and changed by resizes after), which the kernel
    reads as its node column; ``width_host`` is its copy on the host,
    written beside every device write, which the pass generators read as
    ``host["nodes"]``.  ``seg_start`` (the clock that opened the job's
    current width segment) and ``node_s`` (the closed segments' width x
    wall seconds) are on the device, closed at completions on the device.
    The host alone writes ``prev_w`` (the width at the latest dispatch or
    resize, 0 before the first dispatch), ``n_resizes``, ``disp_dur`` (the
    dilated duration chosen at the latest dispatch, -1 before it) and
    ``requeued`` (the remaining time a requeue kill charged, the basis of
    the redispatch's re-dilation).  A solo run's lists have one entry."""

    ctx: list
    ptr: list
    width: torch.Tensor        # i32[..., J]
    seg_start: torch.Tensor    # i32[..., J]
    node_s: torch.Tensor       # i32[..., J]
    width_host: np.ndarray     # i32[..., J]
    prev_w: np.ndarray         # i32[..., J]
    n_resizes: np.ndarray      # i32[..., J]
    disp_dur: np.ndarray       # i32[..., J]
    requeued: np.ndarray       # i32[..., J]

    @classmethod
    def init(cls, ctxs, J: int, device, batch=()) -> "MalState":
        wlo = np.array([c.min_width for c in ctxs], dtype=np.int32)
        width = np.broadcast_to((wlo if batch else wlo[0])[..., None],
                                (*batch, J)).copy()
        zeros = np.zeros((*batch, J), dtype=np.int32)
        dev = torch.zeros((*batch, J), dtype=torch.int32, device=device)
        return cls(ctx=list(ctxs), ptr=[0] * len(ctxs),
                   width=torch.tensor(width, device=device),
                   seg_start=dev, node_s=dev.clone(), width_host=width,
                   prev_w=zeros, n_resizes=zeros.copy(),
                   disp_dur=np.full((*batch, J), -1, dtype=np.int32),
                   requeued=zeros.copy())


@dataclasses.dataclass
class SimState(_AllocViews):
    """Simulation state of one cluster, updated in place by the engine.

    The reference threads an immutable state through ``lax.while_loop``;
    here the host drives the loop, so the per-job tensors are written in
    place (no copy per start) and the scalars are host ints.  Without a
    machine ``node_owner`` and the ``ev_*`` log have length 0, as in the
    reference.  ``ev_time`` and ``ev_free`` are host numpy arrays (the
    host knows both after each event); ``ev_lfb`` lives on the device.
    ``lfb`` is the host's copy of the largest free run when the strategy's
    placement cap is that run (``contiguous``), else ``None``.  ``n_unmet``
    counts each job's dependencies that are not DONE yet (``None`` for a
    table without edges).
    """

    clock: int
    jstate: torch.Tensor      # i32[J] in {PENDING, WAITING, RUNNING, DONE}
    start: torch.Tensor       # i32[J] FIRST start time (INF until started)
    finish: torch.Tensor      # i32[J] completion time (INF until started)
    rsv_finish: torch.Tensor  # i32[J] start + estimate (EASY shadow input)
    remaining: torch.Tensor   # i32[J] runtime left (preemption suspends work)
    free: int                 # nodes currently free
    n_events: int             # events processed
    node_owner: torch.Tensor  # i32[N] owning job row per node (-1 free)
    alloc: torch.Tensor       # i32[3, J] alloc_first / alloc_span / alloc_sum
    ev_time: np.ndarray       # i32[L] event clock log (-1 = unused slot)
    ev_free: np.ndarray       # i32[L] free nodes after each event
    ev_lfb: torch.Tensor      # i32[L] largest free run after each event
    lfb: int | None = None
    n_unmet: Optional[torch.Tensor] = None   # i32[J] unmet dependencies
    rel: Optional[RelState] = None
    svc: Optional[SvcState] = None
    mal: Optional[MalState] = None

    @classmethod
    def init(cls, jobs: JobSet, total_nodes: int, machine=None,
             event_log: int = 0, failures=None, service=None,
             malleable=None) -> "SimState":
        """``failures``/``service``/``malleable``: the run's
        ``FailCtx``/``SvcCtx``/``MalCtx`` (or ``None``)."""
        J, dev = jobs.capacity, jobs.device
        N = machine.n_nodes if machine is not None else 0
        L = int(event_log) if machine is not None else 0
        inf = torch.full((J,), INF_TIME, dtype=torch.int32, device=dev)
        return cls(
            clock=0,
            jstate=torch.where(jobs.valid, PENDING, DONE).to(torch.int32),
            start=inf,
            finish=inf.clone(),
            rsv_finish=inf.clone(),
            remaining=jobs.runtime.clone(),
            free=int(total_nodes),
            n_events=0,
            **machine_fields(J, N, L, dev),
            n_unmet=in_degrees(jobs),
            rel=None if failures is None else RelState.init(
                [failures], J, N, dev),
            svc=None if service is None else SvcState.init(
                [service], [total_nodes], N, dev),
            mal=None if malleable is None else MalState.init(
                [malleable], J, dev),
        )


class MemberScalars:
    """The host scalars of one ensemble member, read and written by its
    scheduling pass as a ``SimState``'s are."""

    __slots__ = ("clock", "free", "n_events", "lfb")

    def __init__(self, clock: int, free: int, n_events: int):
        self.clock, self.free, self.n_events = clock, free, n_events
        self.lfb = None


@dataclasses.dataclass
class EnsembleState(_AllocViews):
    """Simulation state of B members in lockstep.

    The per-job tensors are ``[B, J]`` (the occupancy maps ``[B, N]``, the
    ``ev_*`` logs ``[B, L]``) and are written in place, so a member's row
    keeps its address for the batched kernels; ``members[b]`` holds member
    ``b``'s ``clock``, ``free``, ``n_events`` and ``lfb``; ``n_unmet`` is
    ``[B, J]`` when the stack carries edges.  A member that is
    done (no unfinished job, or its event cap reached) is never written
    again.
    """

    jstate: torch.Tensor      # i32[B, J]
    start: torch.Tensor       # i32[B, J]
    finish: torch.Tensor      # i32[B, J]
    rsv_finish: torch.Tensor  # i32[B, J]
    remaining: torch.Tensor   # i32[B, J]
    members: list             # [MemberScalars] * B
    node_owner: torch.Tensor  # i32[B, N]
    alloc: torch.Tensor       # i32[B, 3, J]
    ev_time: np.ndarray       # i32[B, L]
    ev_free: np.ndarray       # i32[B, L]
    ev_lfb: torch.Tensor      # i32[B, L]
    n_unmet: Optional[torch.Tensor] = None   # i32[B, J] unmet dependencies
    rel: Optional[RelState] = None
    svc: Optional[SvcState] = None
    mal: Optional[MalState] = None

    @classmethod
    def init(cls, jobs: JobSet, total_nodes, machine=None,
             event_log: int = 0, failures_b=None, service_b=None,
             malleable_b=None) -> "EnsembleState":
        """``failures_b``/``service_b``/``malleable_b``: one
        ``FailCtx``/``SvcCtx``/``MalCtx`` a member (or ``None``)."""
        B, dev = jobs.batch, jobs.device
        N = machine.n_nodes if machine is not None else 0
        L = int(event_log) if machine is not None else 0
        inf = torch.full(jobs.submit.shape, INF_TIME, dtype=torch.int32,
                         device=dev)
        return cls(
            jstate=torch.where(jobs.valid, PENDING, DONE).to(torch.int32),
            start=inf,
            finish=inf.clone(),
            rsv_finish=inf.clone(),
            remaining=jobs.runtime.clone(),
            members=[MemberScalars(0, int(t), 0) for t in total_nodes],
            **machine_fields(jobs.capacity, N, L, dev, (B,)),
            n_unmet=in_degrees(jobs),
            rel=None if failures_b is None else RelState.init(
                failures_b, jobs.capacity, N, dev, (B,)),
            svc=None if service_b is None else SvcState.init(
                service_b, total_nodes, N, dev, (B,)),
            mal=None if malleable_b is None else MalState.init(
                malleable_b, jobs.capacity, dev, (B,)),
        )

    @property
    def n_events(self) -> list:
        return [m.n_events for m in self.members]


def _member(x, b: int):
    """Row ``b`` of an ensemble's result field (``None`` stays ``None``)."""
    if x is None:
        return None
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _member(getattr(x, f.name), b)
                          for f in dataclasses.fields(x)})
    return x[b]


@dataclasses.dataclass(frozen=True)
class FailureInfo:
    """Per-job reliability columns of a result (``SimResult.rel``)."""

    n_restarts: torch.Tensor  # i32[J] requeue kills survived
    lost_work: torch.Tensor   # i32[J] rework + overhead (+ aborted work)
    aborted: torch.Tensor     # bool[J] terminated by a failure under abort


@dataclasses.dataclass(frozen=True)
class SvcInfo:
    """Per-request serving columns of a result (``SimResult.svc``)."""

    slo_met: torch.Tensor     # bool[J] started by its deadline, and done
    deadline: torch.Tensor    # i32[J] submit + slo_wait (INF_TIME = pad)
    cap_online: torch.Tensor  # i32[T] online nodes after each tick (-1)


@dataclasses.dataclass(frozen=True)
class MalInfo:
    """Per-job malleability columns of a result (``SimResult.mal``)."""

    width: torch.Tensor       # i32[J] final width (min_width if never run)
    nref: torch.Tensor        # i32[J] reference (requested) width
    n_resizes: torch.Tensor   # i32[J] grows, shrinks and failure shrinks
    node_s: torch.Tensor      # i32[J] width x wall seconds, every segment
    disp_dur: torch.Tensor    # i32[J] dilated duration at the latest
                              #        dispatch (-1: never dispatched)


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Per-job outcome of a run.  The allocation fingerprints and the
    ``ev_*`` log are those of the state (``-1``/0 and length 0 without a
    machine); ``rel``, ``svc`` and ``mal`` carry the reliability, serving
    and malleability columns (``None`` when the source was off)."""

    start: torch.Tensor   # i32[J]
    finish: torch.Tensor  # i32[J]
    ready: torch.Tensor   # i32[J] max(submit, last dependency's finish)
    wait: torch.Tensor    # i32[J] start - ready
    makespan: int         # a list of B ints for an ensemble
    n_events: int         # a list of B ints for an ensemble
    done: torch.Tensor    # bool[J] completed (False => aborted or cap hit)
    alloc_first: torch.Tensor  # i32[J] lowest node id of final allocation
    alloc_span: torch.Tensor   # i32[J] topology groups spanned by it
    alloc_sum: torch.Tensor    # i32[J] sum of its 1-based node ids
    ev_time: torch.Tensor      # i32[L] per-event clock (-1 = unused slot)
    ev_free: torch.Tensor      # i32[L] per-event free-node count
    ev_lfb: torch.Tensor       # i32[L] per-event largest free run
    rel: Optional[FailureInfo] = None
    svc: Optional[SvcInfo] = None
    mal: Optional[MalInfo] = None

    def member(self, b: int) -> "SimResult":
        """Row ``b`` of an ensemble's result (``[B, ...]`` fields)."""
        return _member(self, b)


def result_from_state(jobs: JobSet, state) -> SimResult:
    """The result of a solo run (``SimState``) or of an ensemble
    (``EnsembleState``: ``[B, ...]`` fields, per-member makespan and event
    count).  An aborted job reached DONE only to end its run: it is not
    done, and its kill time is no part of the makespan."""
    ready = (jobs.submit if jobs.dep_dst is None else torch.maximum(
        jobs.submit, dependency_finish(jobs, state.finish)))
    wait = torch.where(jobs.valid, state.start - ready, 0).to(torch.int32)
    done = (state.jstate == DONE) & jobs.valid
    rel = svc = mal = None
    if state.rel is not None:
        done &= ~state.rel.aborted
        rel = FailureInfo(n_restarts=state.rel.n_restarts,
                          lost_work=state.rel.lost_work,
                          aborted=state.rel.aborted)
    fin = torch.where(done, state.finish, 0)
    dev = jobs.device
    if state.svc is not None:
        svc = SvcInfo(slo_met=done & (state.start <= state.svc.deadline),
                      deadline=state.svc.deadline,
                      cap_online=torch.from_numpy(
                          state.svc.cap_online).to(dev))
    if state.mal is not None:
        m = state.mal
        nref = np.stack([c.nref for c in m.ctx])
        mal = MalInfo(
            width=m.width,
            nref=torch.from_numpy(nref if jobs.batch else nref[0]).to(dev),
            n_resizes=torch.from_numpy(m.n_resizes).to(dev),
            node_s=m.node_s,
            disp_dur=torch.from_numpy(m.disp_dur).to(dev))
    return SimResult(
        start=state.start,
        finish=state.finish,
        ready=ready,
        wait=wait,
        makespan=fin.amax(dim=-1).tolist(),
        n_events=state.n_events,
        done=done,
        alloc_first=state.alloc_first,
        alloc_span=state.alloc_span,
        alloc_sum=state.alloc_sum,
        ev_time=torch.from_numpy(state.ev_time).to(dev),
        ev_free=torch.from_numpy(state.ev_free).to(dev),
        ev_lfb=state.ev_lfb,
        rel=rel,
        svc=svc,
        mal=mal,
    )
