"""Declarative experiment specs of the PyTorch port.

Counterpart of ``repro.api.scenario`` for the ported slices: a
:class:`Scenario` names a trace (:class:`SyntheticTrace`, :class:`SwfTrace`,
:class:`WorkflowTrace`, :class:`ArrayTrace` or an open-arrival
``ServiceTrace``), the cluster size, the policy, optionally a machine shape
(:class:`Topology`) with its placement strategy and contention model, a
node-failure model (``FailureModel``), a malleable-jobs model
(``MalleableModel``), the padded table capacity and an event cap, and
whether the run is partitioned into conservatively synchronized clusters
(:class:`Multicluster`, with one trace spec and one node count a
cluster).  The same field values describe the same run as the reference's
``Scenario``.  Features of the reference that the port does not carry yet
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from repro_torch import alloc as _alloc
from repro_torch.core.jobs import INF_TIME
from repro_torch.malleable import MalleableModel
from repro_torch.reliability import FailureModel
from repro_torch.serving import ServiceTrace
from repro_torch.traces.swf import load_swf
from repro_torch.traces import workflows as _workflows
from repro_torch.traces.synthetic import das2_like, sdsc_sp2_like, synthetic_trace
from repro_torch.traces.workflows import workflow_to_trace


@dataclasses.dataclass(frozen=True)
class SyntheticTrace:
    """Deterministic synthetic workload (``repro_torch.traces.synthetic``).

    ``kind`` selects the generator: ``"generic"``, ``"das2"`` or
    ``"sdsc_sp2"``.  ``params`` are extra generator keyword arguments as
    (name, value) pairs.  ``congest`` divides submit times by an integer
    factor to densify arrivals, so that the policies diverge.
    """

    n_jobs: int = 1000
    seed: int = 0
    kind: str = "generic"
    params: Tuple[Tuple[str, Any], ...] = ()
    congest: int = 1

    _GENERATORS = {"generic": synthetic_trace, "das2": das2_like,
                   "sdsc_sp2": sdsc_sp2_like}

    def materialize(self) -> Dict[str, np.ndarray]:
        try:
            gen = self._GENERATORS[self.kind]
        except KeyError:
            raise ValueError(
                f"unknown synthetic trace kind {self.kind!r}; "
                f"known: {sorted(self._GENERATORS)}") from None
        trace = gen(self.n_jobs, seed=self.seed, **dict(self.params))
        if self.congest != 1:
            trace["submit"] = trace["submit"] // int(self.congest)
        return trace

    def static_key(self):
        """Everything except ``seed``: the seed is trace data, not shape."""
        return ("synthetic", self.n_jobs, self.kind, self.params, self.congest)

    @property
    def n_rows(self) -> int:
        return self.n_jobs


@dataclasses.dataclass(frozen=True)
class SwfTrace:
    """A Standard Workload Format log on disk (optionally gzipped).

    ``strict=True`` raises on the first malformed line instead of counting
    it.  The one-shot engine keeps its clock in int32, so a log whose span
    plus twice its longest job reaches ``INF_TIME`` is refused.
    """

    path: str
    max_jobs: Optional[int] = None
    strict: bool = False

    def materialize(self) -> Dict[str, np.ndarray]:
        trace, _report = load_swf(self.path, max_jobs=self.max_jobs,
                                  strict=self.strict)
        sub = np.asarray(trace["submit"], dtype=np.int64)
        if len(sub):
            run = np.asarray(trace["runtime"], dtype=np.int64)
            est = np.asarray(trace.get("estimate", run), dtype=np.int64)
            top = int(sub.max() - sub.min()) + 2 * int(
                max(run.max(initial=1), est.max(initial=1)))
            if top >= INF_TIME:
                raise ValueError(
                    f"SWF trace {self.path!r} overflows int32 clock range: "
                    f"submit span + 2*max runtime = {top} >= {INF_TIME} "
                    "(INF_TIME); trim the log with max_jobs= or rescale "
                    "its time unit")
        return trace

    def static_key(self):
        return ("swf", self.path, self.max_jobs)

    @property
    def n_rows(self) -> Optional[int]:
        return None  # unknown until loaded


@dataclasses.dataclass(frozen=True)
class WorkflowTrace:
    """A workflow DAG scheduled onto the cluster (paper §3, DESIGN.md §13).

    ``kind`` selects the ``repro_torch.traces.workflows`` generator:
    ``"montage"``, ``"galactic"`` (Galactic Plane: K montage tiles and a
    merge), ``"sipht"``, ``"chain"``, ``"fork_join"`` or ``"random"`` (a
    random layered DAG).  ``params`` are generator keyword arguments as
    (name, value) pairs, e.g. ``(("tiles", 4), ("width", 8))``.  The DAG
    lowers through ``workflow_to_trace``: tasks become jobs (cpu
    requirement -> node count), edges become the job table's edge list, and
    every task shares one ``submit`` time, so release order is driven by
    the dependencies alone.  The shape (kind, params, submit, priority) is
    the static key; ``seed`` is data within one sweep bucket, even where it
    changes the edge count (``stack_jobsets`` pads ragged edge lists).
    ``priority="cpath"`` attaches critical-path priorities for ``preempt``.
    """

    kind: str = "montage"
    seed: int = 0
    params: Tuple[Tuple[str, Any], ...] = ()
    submit: int = 0
    priority: Optional[str] = None

    _GENERATORS = {
        "montage": _workflows.montage_like,
        "galactic": _workflows.galactic_like,
        "sipht": _workflows.sipht_like,
        "chain": _workflows.chain,
        "fork_join": _workflows.fork_join,
        "random": _workflows.random_layered,
    }
    _SEEDLESS = frozenset({"chain"})

    def materialize(self) -> Dict[str, np.ndarray]:
        # a shallow copy of the cached dict: the spec is frozen and
        # hashable, so a sweep's points and n_rows reuse one DAG
        return dict(_materialize_workflow(self))

    def static_key(self):
        """Everything except ``seed``: (kind, params) fix the task count."""
        return ("workflow", self.kind, self.params, self.submit,
                self.priority)

    @property
    def n_rows(self) -> int:
        return len(self.materialize()["submit"])


@functools.lru_cache(maxsize=128)
def _materialize_workflow(spec: WorkflowTrace) -> Dict[str, np.ndarray]:
    try:
        gen = spec._GENERATORS[spec.kind]
    except KeyError:
        raise ValueError(
            f"unknown workflow kind {spec.kind!r}; "
            f"known: {sorted(spec._GENERATORS)}") from None
    kwargs = dict(spec.params)
    if spec.kind not in spec._SEEDLESS:
        kwargs["seed"] = spec.seed
    return workflow_to_trace(gen(**kwargs), submit=spec.submit,
                             priority=spec.priority)


@dataclasses.dataclass(frozen=True, eq=False)
class ArrayTrace:
    """Explicit host arrays.  ``deps`` (optional ``(job, dependency)``
    pairs or a dense bool matrix, in input order) makes the jobs a
    workflow (DESIGN.md §13).

    ``eq=False`` keeps the spec hashable by identity: two array traces are
    the same trace for a sweep's buckets and job-table cache only when they
    are the same object.
    """

    submit: Any
    runtime: Any
    nodes: Any
    estimate: Any = None
    priority: Any = None
    deps: Any = None

    @classmethod
    def from_dict(cls, trace: Dict[str, Any]) -> "ArrayTrace":
        return cls(submit=trace["submit"], runtime=trace["runtime"],
                   nodes=trace["nodes"], estimate=trace.get("estimate"),
                   priority=trace.get("priority"), deps=trace.get("deps"))

    def materialize(self) -> Dict[str, np.ndarray]:
        out = {"submit": np.asarray(self.submit),
               "runtime": np.asarray(self.runtime),
               "nodes": np.asarray(self.nodes)}
        if self.estimate is not None:
            out["estimate"] = np.asarray(self.estimate)
        if self.priority is not None:
            out["priority"] = np.asarray(self.priority)
        if self.deps is not None:
            out["deps"] = self.deps
        return out

    def static_key(self):
        return ("arrays", id(self))

    @property
    def n_rows(self) -> int:
        return len(np.asarray(self.submit))


TraceSpec = Union[SyntheticTrace, SwfTrace, WorkflowTrace, ArrayTrace,
                  ServiceTrace]


def as_trace_spec(trace) -> TraceSpec:
    """Accept a spec, a plain dict of arrays, or an .swf path string."""
    if isinstance(trace, (SyntheticTrace, SwfTrace, WorkflowTrace, ArrayTrace,
                          ServiceTrace)):
        return trace
    if isinstance(trace, dict):
        return ArrayTrace.from_dict(trace)
    if isinstance(trace, str):
        return SwfTrace(trace)
    raise NotImplementedError(
        f"trace {type(trace).__name__} is not ported yet: injected what-if "
        "jobs are ROADMAP Queue 1 item 8")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Declarative machine shape; builds a ``repro_torch.alloc.Machine``.

    ``kind`` is "linear", "mesh2d" or "dragonfly"; ``shape`` the constructor's
    positional arguments: (n_nodes, group_size), (rows, cols) or (n_groups,
    nodes_per_group).
    """

    kind: str
    shape: Tuple[int, int]

    @classmethod
    def linear(cls, n_nodes: int, *, group_size: int = 8) -> "Topology":
        return cls("linear", (int(n_nodes), int(group_size)))

    @classmethod
    def mesh2d(cls, rows: int, cols: int) -> "Topology":
        return cls("mesh2d", (int(rows), int(cols)))

    @classmethod
    def dragonfly(cls, n_groups: int, nodes_per_group: int) -> "Topology":
        return cls("dragonfly", (int(n_groups), int(nodes_per_group)))

    @property
    def n_nodes(self) -> int:
        if self.kind == "linear":
            return self.shape[0]
        return self.shape[0] * self.shape[1]

    def build(self, device=None) -> _alloc.Machine:
        """The machine on ``device`` (``cuda`` by default)."""
        a, b = self.shape
        if self.kind == "linear":
            return _alloc.linear(a, group_size=b, device=device)
        if self.kind == "mesh2d":
            return _alloc.mesh2d(a, b, device=device)
        if self.kind == "dragonfly":
            return _alloc.dragonfly(a, b, device=device)
        raise ValueError(
            f"unknown topology kind {self.kind!r}; "
            "known: linear, mesh2d, dragonfly")


@dataclasses.dataclass(frozen=True)
class Multicluster:
    """Conservative-window multi-cluster settings (DESIGN.md §2).

    When set on a :class:`Scenario`, ``trace`` must be a tuple of trace
    specs (one a cluster) and ``total_nodes`` is per cluster (one int for
    every cluster, or a tuple).
    """

    window: int
    horizon: Optional[int] = None   # None: derived from the traces
    migrate: bool = True
    max_export: int = 8
    latency: Optional[int] = None   # None: == window (the least conservative)
    load_imbalance_threshold: float = 1.5


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One experiment, on one cluster or, with ``multicluster``, on several.

    ``trace`` is a trace spec, a dict of arrays or an .swf path;
    ``total_nodes`` the cluster size (default: the topology's node count);
    ``policy`` a name or id; ``topology`` a :class:`Topology` (``None``:
    scalar-counter mode); ``alloc`` its placement strategy (a name or id,
    default ``simple``) and ``contention`` its runtime dilation (``None``,
    ``(num, den)`` or a ``Contention``), both of which need a topology;
    ``capacity`` pads the job table (a ``ServiceTrace`` pads it to its
    ``max_jobs``); ``max_events`` caps the event loop.  ``failures`` (a
    frozen ``FailureModel``) switches on node failures (DESIGN.md §15),
    ``malleable`` (a frozen ``MalleableModel``) malleable jobs (§17), which
    refuse contention, preempt and multicluster as the reference's do.
    ``multicluster`` (a :class:`Multicluster`) partitions the run into
    clusters: ``trace`` is then a tuple of specs, one a cluster, and
    ``total_nodes`` one int for every cluster or a tuple; failures,
    malleable jobs, a ``ServiceTrace`` and (at ``run``) a topology are
    refused with it, as the reference refuses them.
    """

    trace: Union[TraceSpec, Dict[str, Any], str, Tuple[TraceSpec, ...]]
    total_nodes: Optional[Union[int, Tuple[int, ...]]] = None
    policy: Union[str, int] = "fcfs"
    topology: Optional[Topology] = None
    alloc: Optional[Union[str, int]] = None
    contention: Optional[Any] = None
    capacity: Optional[int] = None
    max_events: Optional[int] = None
    failures: Optional[FailureModel] = None
    malleable: Optional[MalleableModel] = None
    multicluster: Optional[Multicluster] = None

    def __post_init__(self):
        if self.malleable is not None:
            if not isinstance(self.malleable, MalleableModel):
                raise TypeError(
                    "Scenario.malleable must be a repro_torch.malleable."
                    f"MalleableModel, got {type(self.malleable).__name__} "
                    "(specs stay frozen/hashable; materialized "
                    "MalleablePlans belong to the engine call, not the "
                    "scenario)")
            if self.multicluster is not None:
                raise ValueError(
                    "malleable jobs are not supported in multicluster "
                    "scenarios yet; simulate the clusters individually")
            if self.contention is not None:
                raise ValueError(
                    "malleable jobs cannot be combined with contention "
                    "dilation: the speedup curve already rescales runtime "
                    "per width, and composing the two dilations is "
                    "undefined (DESIGN.md §17)")
            if self.policy == "preempt":
                raise ValueError(
                    "malleable jobs cannot be combined with the preempt "
                    "policy (width-aware preemption is an open item, "
                    "DESIGN.md §17)")
        if self.failures is not None:
            if not isinstance(self.failures, FailureModel):
                raise TypeError(
                    "Scenario.failures must be a repro_torch.reliability."
                    f"FailureModel, got {type(self.failures).__name__} "
                    "(specs stay frozen/hashable; materialized "
                    "FailureTraces belong to the engine call, not the "
                    "scenario)")
            if self.multicluster is not None:
                raise ValueError(
                    "failures are not supported in multicluster scenarios "
                    "yet; simulate the clusters individually")
        if self.multicluster is None:
            object.__setattr__(self, "trace", as_trace_spec(self.trace))
        else:
            if not isinstance(self.trace, (tuple, list)):
                raise ValueError(
                    "multicluster scenarios take one trace spec per cluster "
                    "(a tuple); got a single trace")
            object.__setattr__(
                self, "trace", tuple(as_trace_spec(t) for t in self.trace))
            if any(isinstance(t, ServiceTrace) for t in self.trace):
                raise ValueError(
                    "ServiceTrace is not supported in multicluster "
                    "scenarios yet; serve each cluster individually")
        if isinstance(self.trace, ServiceTrace):
            if (self.failures is not None and self.topology is not None
                    and self.trace.autoscale is not None):
                raise ValueError(
                    "machine-mode failures cannot be combined with an "
                    "autoscaling ServiceTrace; drop topology=, failures=, "
                    "or autoscale (engine restriction, DESIGN.md §16)")
            if (self.capacity is not None
                    and int(self.capacity) != self.trace.max_jobs):
                raise ValueError(
                    f"capacity={self.capacity} disagrees with "
                    f"ServiceTrace.max_jobs={self.trace.max_jobs}; the "
                    "deadline/class columns are padded to max_jobs, so the "
                    "job table must share that shape")
        if self.topology is None and (self.alloc is not None
                                      or self.contention is not None):
            raise ValueError(
                "alloc/contention require topology=; without a Topology the "
                "simulation runs in scalar-counter mode and would silently "
                "ignore them")
        if self.total_nodes is None:
            if self.topology is None:
                raise ValueError(
                    "total_nodes is required when no topology is given")
            object.__setattr__(self, "total_nodes", self.topology.n_nodes)
        if (self.topology is not None and self.multicluster is None
                and int(self.total_nodes) != self.topology.n_nodes):
            raise ValueError(
                f"topology has {self.topology.n_nodes} nodes but "
                f"total_nodes={self.total_nodes}")

    # -- sweep support ------------------------------------------------------

    def with_(self, **overrides) -> "Scenario":
        """Functional update; keys may be dotted paths into sub-specs,
        e.g. ``with_(policy="sjf", **{"trace.seed": 3})``."""
        flat: Dict[str, Any] = {}
        nested: Dict[str, Dict[str, Any]] = {}
        for key, value in overrides.items():
            if "." in key:
                head, rest = key.split(".", 1)
                nested.setdefault(head, {})[rest] = value
            else:
                flat[key] = value
        for head, sub in nested.items():
            target = flat.get(head, getattr(self, head))
            if target is None:
                raise ValueError(f"cannot set {head}.{next(iter(sub))}: "
                                 f"scenario has no {head}")
            if isinstance(target, tuple):   # per-cluster trace specs
                target = tuple(dataclasses.replace(t, **sub) for t in target)
            else:
                target = dataclasses.replace(target, **sub)
            flat[head] = target
        return dataclasses.replace(self, **flat)

    def trace_specs(self) -> Tuple[TraceSpec, ...]:
        """Per-cluster tuple view of ``trace`` (length 1 without
        multicluster)."""
        return self.trace if isinstance(self.trace, tuple) else (self.trace,)

    def nodes_per_cluster(self) -> Tuple[int, ...]:
        """Per-cluster ``total_nodes`` tuple (length 1 without
        multicluster)."""
        n_clusters = len(self.trace_specs())
        tn = self.total_nodes
        if isinstance(tn, tuple):
            if len(tn) != n_clusters:
                raise ValueError(
                    f"total_nodes tuple has {len(tn)} entries for "
                    f"{n_clusters} clusters")
            return tuple(int(x) for x in tn)
        return (int(tn),) * n_clusters
