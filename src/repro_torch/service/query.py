"""The frozen what-if query schema and its JSON codec (DESIGN.md §20), the
PyTorch port's copy of ``repro.service.query``: the same documents, codes
and messages, built on the port's specs.

A :class:`WhatIfQuery` is a versioned, JSON-round-trippable description of
ONE capacity-planning question against a fleet of named queues:

- ``kind="placement"``  — "where should this job run": inject a candidate
  :class:`JobRequest` into every candidate queue and rank queues by the
  candidate's wait;
- ``kind="capacity"``   — "what happens to p99 wait if we add 64 nodes":
  evaluate a list of :class:`ScenarioDelta`\\ s against one queue;
- ``kind="reliability"``— "which MTBF budget meets a goodput target":
  sweep ``failures.mtbf`` (× optionally ``checkpoint_interval``) grids.

Every query *lowers* onto :class:`repro_torch.api.Scenario` via
:func:`apply_delta`, the same function the differential tests use to
build the equivalent direct-run scenario, so "service answer == ``run()``
/ ``run_ref()`` of the lowered scenario" is checkable bit for bit.

The codec is strict and canonical: unknown or missing fields raise
:class:`SchemaError`, every field is always emitted (no omit-if-default),
and :func:`canonical_dumps` fixes key order and separators, so
serialize → deserialize → re-serialize is byte-identical.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from repro_torch.api.scenario import (
    InjectedTrace, Scenario, SwfTrace, SyntheticTrace, Topology,
    WorkflowTrace,
)
from repro_torch.reliability import FailureModel

SCHEMA_VERSION = 1

QUERY_KINDS = ("placement", "capacity", "reliability")


class SchemaError(ValueError):
    """A query/scenario JSON document violates the v1 schema.

    ``code`` is a stable machine-readable tag the HTTP layer maps onto
    4xx responses: ``unknown_field`` / ``missing_field`` / ``bad_value`` /
    ``bad_version`` / ``unsupported``.
    """

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


def _require(obj: Dict[str, Any], allowed: Dict[str, bool],
             what: str) -> None:
    """Strict key check: every required key present, no unknown keys."""
    if not isinstance(obj, dict):
        raise SchemaError("bad_value", f"{what} must be a JSON object, "
                                       f"got {type(obj).__name__}")
    unknown = sorted(set(obj) - set(allowed))
    if unknown:
        raise SchemaError(
            "unknown_field", f"{what} has unknown field(s) {unknown}; "
            f"allowed: {sorted(allowed)}")
    missing = sorted(k for k, req in allowed.items() if req and k not in obj)
    if missing:
        raise SchemaError(
            "missing_field", f"{what} is missing required field(s) "
            f"{missing}")


def _opt_num(obj, key, what, *, integer=False):
    v = obj.get(key)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise SchemaError("bad_value", f"{what}.{key} must be a number")
    return int(v) if integer else float(v)


def canonical_dumps(obj: Any) -> str:
    """The one canonical JSON encoding (sorted keys, tight separators) —
    what makes round trips byte-comparable."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


# ---------------------------------------------------------------------------
# query dataclasses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JobRequest:
    """The candidate job of a placement query."""

    submit: int
    runtime: int
    nodes: int
    estimate: Optional[int] = None
    priority: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "submit", int(self.submit))
        object.__setattr__(self, "runtime", int(self.runtime))
        object.__setattr__(self, "nodes", int(self.nodes))
        if self.estimate is not None:
            object.__setattr__(self, "estimate", int(self.estimate))
        if self.priority is not None:
            object.__setattr__(self, "priority", int(self.priority))
        if self.runtime < 1 or self.nodes < 1 or self.submit < 0:
            raise SchemaError(
                "bad_value", "job needs submit >= 0, runtime >= 1 and "
                f"nodes >= 1; got {self}")

    def as_tuple(self) -> Tuple[Optional[int], ...]:
        return (self.submit, self.runtime, self.nodes, self.estimate,
                self.priority)

    def to_json_dict(self) -> Dict[str, Any]:
        return {"submit": self.submit, "runtime": self.runtime,
                "nodes": self.nodes, "estimate": self.estimate,
                "priority": self.priority}

    _FIELDS = {"submit": True, "runtime": True, "nodes": True,
               "estimate": False, "priority": False}

    @classmethod
    def from_json_dict(cls, obj: Dict[str, Any]) -> "JobRequest":
        _require(obj, cls._FIELDS, "job")
        try:
            return cls(submit=_opt_num(obj, "submit", "job", integer=True),
                       runtime=_opt_num(obj, "runtime", "job", integer=True),
                       estimate=_opt_num(obj, "estimate", "job",
                                         integer=True),
                       priority=_opt_num(obj, "priority", "job",
                                         integer=True),
                       nodes=_opt_num(obj, "nodes", "job", integer=True))
        except TypeError:
            raise SchemaError(
                "bad_value", "job.submit/runtime/nodes must be numbers")


@dataclasses.dataclass(frozen=True)
class ScenarioDelta:
    """One hypothetical change to a queue's base scenario.

    Any combination of: grow/shrink the machine (``add_nodes``, scalar
    counter or linear topology only), swap the scheduling ``policy`` or the
    ``alloc`` strategy, override the failure model's ``mtbf`` /
    ``checkpoint_interval`` / ``restart_overhead`` (requires the base to
    carry a :class:`FailureModel`), and ``inject`` candidate jobs.  The
    identity delta (all defaults) is valid and means "the queue as-is".
    """

    add_nodes: int = 0
    policy: Optional[str] = None
    alloc: Optional[str] = None
    mtbf: Optional[float] = None
    checkpoint_interval: Optional[int] = None
    restart_overhead: Optional[int] = None
    inject: Tuple[JobRequest, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "add_nodes", int(self.add_nodes))
        object.__setattr__(self, "inject", tuple(self.inject))
        for j in self.inject:
            if not isinstance(j, JobRequest):
                raise SchemaError(
                    "bad_value",
                    f"delta.inject entries must be JobRequests, got "
                    f"{type(j).__name__}")
        if self.mtbf is not None:
            object.__setattr__(self, "mtbf", float(self.mtbf))
            if not self.mtbf > 0:
                raise SchemaError("bad_value",
                                  f"delta.mtbf must be > 0, got {self.mtbf}")
        for k in ("checkpoint_interval", "restart_overhead"):
            v = getattr(self, k)
            if v is not None:
                object.__setattr__(self, k, int(v))
                if getattr(self, k) < 0:
                    raise SchemaError("bad_value", f"delta.{k} must be >= 0")

    def describe(self) -> str:
        """Compact human-readable label for recommendation rows."""
        parts = []
        if self.add_nodes:
            parts.append(f"{self.add_nodes:+d} nodes")
        if self.policy is not None:
            parts.append(f"policy={self.policy}")
        if self.alloc is not None:
            parts.append(f"alloc={self.alloc}")
        if self.mtbf is not None:
            parts.append(f"mtbf={self.mtbf:g}")
        if self.checkpoint_interval is not None:
            parts.append(f"ckpt={self.checkpoint_interval}")
        if self.restart_overhead is not None:
            parts.append(f"restart={self.restart_overhead}")
        if self.inject:
            parts.append(f"+{len(self.inject)} job(s)")
        return ", ".join(parts) if parts else "as-is"

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "add_nodes": self.add_nodes,
            "policy": self.policy,
            "alloc": self.alloc,
            "mtbf": self.mtbf,
            "checkpoint_interval": self.checkpoint_interval,
            "restart_overhead": self.restart_overhead,
            "inject": [j.to_json_dict() for j in self.inject],
        }

    _FIELDS = {"add_nodes": False, "policy": False, "alloc": False,
               "mtbf": False, "checkpoint_interval": False,
               "restart_overhead": False, "inject": False}

    @classmethod
    def from_json_dict(cls, obj: Dict[str, Any]) -> "ScenarioDelta":
        _require(obj, cls._FIELDS, "delta")
        inject = obj.get("inject") or []
        if not isinstance(inject, list):
            raise SchemaError("bad_value", "delta.inject must be a list")
        for k in ("policy", "alloc"):
            if obj.get(k) is not None and not isinstance(obj[k], str):
                raise SchemaError("bad_value", f"delta.{k} must be a string")
        return cls(
            add_nodes=_opt_num(obj, "add_nodes", "delta", integer=True) or 0,
            policy=obj.get("policy"),
            alloc=obj.get("alloc"),
            mtbf=_opt_num(obj, "mtbf", "delta"),
            checkpoint_interval=_opt_num(obj, "checkpoint_interval", "delta",
                                         integer=True),
            restart_overhead=_opt_num(obj, "restart_overhead", "delta",
                                      integer=True),
            inject=tuple(JobRequest.from_json_dict(j) for j in inject),
        )


@dataclasses.dataclass(frozen=True)
class Objective:
    """What the recommendation optimizes: a summary metric, a direction,
    and an optional target level ("meets the goal")."""

    metric: str = "p99_wait"
    goal: str = "min"
    target: Optional[float] = None

    def __post_init__(self):
        if self.goal not in ("min", "max"):
            raise SchemaError(
                "bad_value", f"objective.goal must be 'min' or 'max', "
                f"got {self.goal!r}")
        if self.target is not None:
            object.__setattr__(self, "target", float(self.target))

    def to_json_dict(self) -> Dict[str, Any]:
        return {"metric": self.metric, "goal": self.goal,
                "target": self.target}

    _FIELDS = {"metric": False, "goal": False, "target": False}

    @classmethod
    def from_json_dict(cls, obj: Dict[str, Any]) -> "Objective":
        _require(obj, cls._FIELDS, "objective")
        metric = obj.get("metric", "p99_wait")
        goal = obj.get("goal", "min")
        if not isinstance(metric, str) or not isinstance(goal, str):
            raise SchemaError("bad_value",
                              "objective.metric/goal must be strings")
        return cls(metric=metric, goal=goal,
                   target=_opt_num(obj, "target", "objective"))


@dataclasses.dataclass(frozen=True)
class WhatIfQuery:
    """One versioned what-if question (module docstring).

    ``queue`` names the target queue for capacity/reliability queries;
    ``queues`` restricts placement candidates (None = every fleet queue).
    Either may be None when the fleet has an unambiguous default.
    """

    kind: str
    queue: Optional[str] = None
    queues: Optional[Tuple[str, ...]] = None
    job: Optional[JobRequest] = None
    deltas: Tuple[ScenarioDelta, ...] = ()
    mtbf_grid: Tuple[float, ...] = ()
    checkpoint_grid: Tuple[int, ...] = ()
    objective: Optional[Objective] = None

    def __post_init__(self):
        if self.kind not in QUERY_KINDS:
            raise SchemaError(
                "bad_value", f"kind must be one of {QUERY_KINDS}, "
                f"got {self.kind!r}")
        object.__setattr__(self, "deltas", tuple(self.deltas))
        object.__setattr__(self, "mtbf_grid",
                           tuple(float(m) for m in self.mtbf_grid))
        object.__setattr__(self, "checkpoint_grid",
                           tuple(int(c) for c in self.checkpoint_grid))
        if self.queues is not None:
            object.__setattr__(self, "queues", tuple(self.queues))
        if self.kind == "placement":
            if self.job is None:
                raise SchemaError("missing_field",
                                  "placement queries need a job")
            if self.deltas or self.mtbf_grid or self.checkpoint_grid:
                raise SchemaError(
                    "bad_value", "placement queries take only a job (the "
                    "deltas/mtbf_grid fields belong to capacity/"
                    "reliability queries)")
        elif self.kind == "capacity":
            if not self.deltas:
                raise SchemaError("missing_field",
                                  "capacity queries need >= 1 delta")
            if self.job is not None or self.mtbf_grid:
                raise SchemaError(
                    "bad_value", "capacity queries take deltas only "
                    "(inject jobs through a delta's `inject` field)")
        else:  # reliability
            if not self.mtbf_grid:
                raise SchemaError("missing_field",
                                  "reliability queries need an mtbf_grid")
            if self.job is not None or self.deltas:
                raise SchemaError(
                    "bad_value", "reliability queries take mtbf_grid "
                    "(+ optional checkpoint_grid) only")

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "version": SCHEMA_VERSION,
            "kind": self.kind,
            "queue": self.queue,
            "queues": None if self.queues is None else list(self.queues),
            "job": None if self.job is None else self.job.to_json_dict(),
            "deltas": [d.to_json_dict() for d in self.deltas],
            "mtbf_grid": list(self.mtbf_grid),
            "checkpoint_grid": list(self.checkpoint_grid),
            "objective": (None if self.objective is None
                          else self.objective.to_json_dict()),
        }

    def to_json(self) -> str:
        return canonical_dumps(self.to_json_dict())

    _FIELDS = {"version": True, "kind": True, "queue": False,
               "queues": False, "job": False, "deltas": False,
               "mtbf_grid": False, "checkpoint_grid": False,
               "objective": False}

    @classmethod
    def from_json_dict(cls, obj: Dict[str, Any]) -> "WhatIfQuery":
        _require(obj, cls._FIELDS, "query")
        if obj["version"] != SCHEMA_VERSION:
            raise SchemaError(
                "bad_version", f"unsupported query version "
                f"{obj['version']!r}; this service speaks "
                f"version {SCHEMA_VERSION}")
        if not isinstance(obj["kind"], str):
            raise SchemaError("bad_value", "kind must be a string")
        queues = obj.get("queues")
        if queues is not None:
            if (not isinstance(queues, list)
                    or not all(isinstance(q, str) for q in queues)):
                raise SchemaError("bad_value",
                                  "queues must be a list of strings")
            queues = tuple(queues)
        queue = obj.get("queue")
        if queue is not None and not isinstance(queue, str):
            raise SchemaError("bad_value", "queue must be a string")
        deltas = obj.get("deltas") or []
        mtbf_grid = obj.get("mtbf_grid") or []
        ckpt_grid = obj.get("checkpoint_grid") or []
        for name, grid in (("deltas", deltas), ("mtbf_grid", mtbf_grid),
                           ("checkpoint_grid", ckpt_grid)):
            if not isinstance(grid, list):
                raise SchemaError("bad_value", f"{name} must be a list")
        if any(isinstance(m, bool) or not isinstance(m, (int, float))
               for m in mtbf_grid):
            raise SchemaError("bad_value", "mtbf_grid must hold numbers")
        if any(isinstance(c, bool) or not isinstance(c, int)
               for c in ckpt_grid):
            raise SchemaError("bad_value",
                              "checkpoint_grid must hold integers")
        job = obj.get("job")
        objective = obj.get("objective")
        return cls(
            kind=obj["kind"],
            queue=queue,
            queues=queues,
            job=None if job is None else JobRequest.from_json_dict(job),
            deltas=tuple(ScenarioDelta.from_json_dict(d) for d in deltas),
            mtbf_grid=tuple(float(m) for m in mtbf_grid),
            checkpoint_grid=tuple(ckpt_grid),
            objective=(None if objective is None
                       else Objective.from_json_dict(objective)),
        )

    @classmethod
    def from_json(cls, text: str) -> "WhatIfQuery":
        try:
            obj = json.loads(text)
        except json.JSONDecodeError as e:
            raise SchemaError("bad_value", f"query is not valid JSON: {e}")
        return cls.from_json_dict(obj)

    def default_objective(self) -> Objective:
        """The per-kind objective when the query leaves it None."""
        if self.objective is not None:
            return self.objective
        if self.kind == "placement":
            return Objective(metric="candidate_wait", goal="min")
        if self.kind == "reliability":
            return Objective(metric="goodput", goal="max")
        return Objective(metric="p99_wait", goal="min")


# ---------------------------------------------------------------------------
# delta -> Scenario lowering (shared with the differential test harness)
# ---------------------------------------------------------------------------


def apply_delta(base: Scenario, delta: ScenarioDelta) -> Scenario:
    """Lower one :class:`ScenarioDelta` onto a base :class:`Scenario`.

    This is the semantics of a what-if point: the service's answer for a
    delta is bit-exact against ``run(apply_delta(base, delta))`` and
    ``run_ref(...)`` of the very same scenario.
    """
    overrides: Dict[str, Any] = {}
    if delta.policy is not None:
        overrides["policy"] = delta.policy
    if delta.alloc is not None:
        if base.topology is None:
            raise SchemaError(
                "unsupported", "delta swaps alloc but the queue has no "
                "topology (scalar-counter queues ignore placement)")
        overrides["alloc"] = delta.alloc
    if delta.add_nodes:
        if base.topology is None:
            n = int(base.total_nodes) + delta.add_nodes
            if n < 1:
                raise SchemaError(
                    "bad_value", f"delta removes {-delta.add_nodes} nodes "
                    f"from a {base.total_nodes}-node queue")
            overrides["total_nodes"] = n
        elif base.topology.kind == "linear":
            n = base.topology.shape[0] + delta.add_nodes
            if n < 1:
                raise SchemaError(
                    "bad_value", f"delta removes {-delta.add_nodes} nodes "
                    f"from a {base.topology.shape[0]}-node linear machine")
            overrides["topology"] = Topology("linear",
                                             (n, base.topology.shape[1]))
            overrides["total_nodes"] = n
        else:
            raise SchemaError(
                "unsupported", f"add_nodes on a {base.topology.kind} "
                "topology is ambiguous (which rows/groups grow?); "
                "model it as a scalar-counter or linear queue")
    for field, key in (("mtbf", "failures.mtbf"),
                       ("checkpoint_interval",
                        "failures.checkpoint_interval"),
                       ("restart_overhead", "failures.restart_overhead")):
        v = getattr(delta, field)
        if v is not None:
            if base.failures is None:
                raise SchemaError(
                    "unsupported", f"delta sets {field} but the queue "
                    "carries no FailureModel; give the base scenario a "
                    "failures= spec first")
            overrides[key] = v
    scn = base.with_(**overrides) if overrides else base
    if delta.inject:
        jobs = tuple(j.as_tuple() for j in delta.inject)
        trace = scn.trace
        if isinstance(trace, InjectedTrace):
            trace = InjectedTrace(base=trace.base,
                                  jobs=trace.jobs + jobs)
        else:
            trace = InjectedTrace(base=trace, jobs=jobs)
        scn = dataclasses.replace(scn, trace=trace)
    return scn


# ---------------------------------------------------------------------------
# Scenario <-> JSON (the fleet-config codec)
# ---------------------------------------------------------------------------

_TRACE_FIELDS = {
    "synthetic": {"type": True, "n_jobs": False, "seed": False,
                  "kind": False, "params": False, "congest": False},
    "workflow": {"type": True, "kind": False, "seed": False,
                 "params": False, "submit": False, "priority": False},
    "swf": {"type": True, "path": True, "max_jobs": False, "strict": False},
    "inject": {"type": True, "base": True, "jobs": True},
}


def trace_to_json(spec) -> Dict[str, Any]:
    if isinstance(spec, SyntheticTrace):
        return {"type": "synthetic", "n_jobs": spec.n_jobs,
                "seed": spec.seed, "kind": spec.kind,
                "params": dict(spec.params), "congest": spec.congest}
    if isinstance(spec, WorkflowTrace):
        return {"type": "workflow", "kind": spec.kind, "seed": spec.seed,
                "params": dict(spec.params), "submit": spec.submit,
                "priority": spec.priority}
    if isinstance(spec, SwfTrace):
        return {"type": "swf", "path": spec.path,
                "max_jobs": spec.max_jobs, "strict": spec.strict}
    if isinstance(spec, InjectedTrace):
        return {"type": "inject", "base": trace_to_json(spec.base),
                "jobs": [list(j) for j in spec.jobs]}
    raise SchemaError(
        "unsupported", f"trace spec {type(spec).__name__} has no JSON form "
        "(ArrayTrace/ServiceTrace queues cannot be described in a fleet "
        "config)")


def trace_from_json(obj: Dict[str, Any]):
    if not isinstance(obj, dict) or "type" not in obj:
        raise SchemaError("missing_field",
                          "trace needs a 'type' field")
    kind = obj["type"]
    if kind not in _TRACE_FIELDS:
        raise SchemaError(
            "bad_value", f"unknown trace type {kind!r}; known: "
            f"{sorted(_TRACE_FIELDS)}")
    _require(obj, _TRACE_FIELDS[kind], f"trace[{kind}]")
    if kind == "synthetic":
        params = obj.get("params") or {}
        return SyntheticTrace(
            n_jobs=int(obj.get("n_jobs", 1000)), seed=int(obj.get("seed", 0)),
            kind=obj.get("kind", "generic"),
            params=tuple(sorted(params.items())),
            congest=int(obj.get("congest", 1)))
    if kind == "workflow":
        params = obj.get("params") or {}
        return WorkflowTrace(
            kind=obj.get("kind", "montage"), seed=int(obj.get("seed", 0)),
            params=tuple(sorted(params.items())),
            submit=int(obj.get("submit", 0)), priority=obj.get("priority"))
    if kind == "swf":
        return SwfTrace(path=obj["path"], max_jobs=obj.get("max_jobs"),
                        strict=bool(obj.get("strict", False)))
    jobs = obj["jobs"]
    if not isinstance(jobs, list):
        raise SchemaError("bad_value", "trace[inject].jobs must be a list")
    return InjectedTrace(base=trace_from_json(obj["base"]),
                         jobs=tuple(tuple(j) for j in jobs))


_SCENARIO_FIELDS = {"version": True, "trace": True, "total_nodes": False,
                    "policy": False, "topology": False, "alloc": False,
                    "contention": False, "capacity": False,
                    "max_events": False, "failures": False}

_FAILURE_FIELDS = {"mtbf": True, "seed": False, "distribution": False,
                   "k": False, "mean_repair": False, "horizon": False,
                   "max_failures": False, "requeue": False,
                   "checkpoint_interval": False, "restart_overhead": False}


def scenario_to_json(scn: Scenario) -> Dict[str, Any]:
    """Serialize a queue scenario (the serviceable subset) to JSON."""
    for field, why in (("multicluster", "multicluster queues"),
                       ("malleable", "malleable queues")):
        if getattr(scn, field) is not None:
            raise SchemaError("unsupported",
                              f"{why} have no JSON form yet")
    if scn.contention is not None and not isinstance(
            scn.contention, (tuple, list)):
        raise SchemaError(
            "unsupported", "only (num, den) contention tuples serialize")
    out = {
        "version": SCHEMA_VERSION,
        "trace": trace_to_json(scn.trace),
        "total_nodes": int(scn.total_nodes),
        "policy": str(scn.policy),
        "topology": (None if scn.topology is None
                     else {"kind": scn.topology.kind,
                           "shape": list(scn.topology.shape)}),
        "alloc": scn.alloc,
        "contention": (None if scn.contention is None
                       else [int(x) for x in scn.contention]),
        "capacity": scn.capacity,
        "max_events": scn.max_events,
        "failures": None,
    }
    if scn.failures is not None:
        f = scn.failures
        out["failures"] = {
            "mtbf": float(f.mtbf), "seed": f.seed,
            "distribution": f.distribution, "k": float(f.k),
            "mean_repair": f.mean_repair, "horizon": f.horizon,
            "max_failures": f.max_failures, "requeue": f.requeue,
            "checkpoint_interval": f.checkpoint_interval,
            "restart_overhead": f.restart_overhead,
        }
    return out


def scenario_from_json(obj: Dict[str, Any]) -> Scenario:
    _require(obj, _SCENARIO_FIELDS, "scenario")
    if obj["version"] != SCHEMA_VERSION:
        raise SchemaError(
            "bad_version", f"unsupported scenario version "
            f"{obj['version']!r}; this service speaks version "
            f"{SCHEMA_VERSION}")
    topology = None
    topo = obj.get("topology")
    if topo is not None:
        _require(topo, {"kind": True, "shape": True}, "topology")
        shape = topo["shape"]
        if not isinstance(shape, list) or len(shape) != 2:
            raise SchemaError("bad_value",
                              "topology.shape must be a 2-element list")
        topology = Topology(topo["kind"], (int(shape[0]), int(shape[1])))
    failures = None
    fobj = obj.get("failures")
    if fobj is not None:
        _require(fobj, _FAILURE_FIELDS, "failures")
        defaults = FailureModel(mtbf=1.0)
        try:
            failures = FailureModel(
                mtbf=float(fobj["mtbf"]),
                seed=int(fobj.get("seed", defaults.seed)),
                distribution=fobj.get("distribution",
                                      defaults.distribution),
                k=float(fobj.get("k", defaults.k)),
                mean_repair=int(fobj.get("mean_repair",
                                         defaults.mean_repair)),
                horizon=int(fobj.get("horizon", defaults.horizon)),
                max_failures=int(fobj.get("max_failures",
                                          defaults.max_failures)),
                requeue=fobj.get("requeue", defaults.requeue),
                checkpoint_interval=int(
                    fobj.get("checkpoint_interval",
                             defaults.checkpoint_interval)),
                restart_overhead=int(fobj.get("restart_overhead",
                                              defaults.restart_overhead)),
            )
        except ValueError as e:
            raise SchemaError("bad_value", f"bad failures spec: {e}")
    contention = obj.get("contention")
    if contention is not None:
        if not isinstance(contention, list) or len(contention) != 2:
            raise SchemaError("bad_value",
                              "contention must be a [num, den] pair")
        contention = (int(contention[0]), int(contention[1]))
    try:
        return Scenario(
            trace=trace_from_json(obj["trace"]),
            total_nodes=obj.get("total_nodes"),
            policy=obj.get("policy", "fcfs"),
            topology=topology,
            alloc=obj.get("alloc"),
            contention=contention,
            capacity=obj.get("capacity"),
            max_events=obj.get("max_events"),
            failures=failures,
        )
    except (ValueError, TypeError) as e:
        if isinstance(e, SchemaError):
            raise
        raise SchemaError("bad_value", f"bad scenario: {e}")


def fleet_to_json(fleet: Dict[str, Scenario]) -> Dict[str, Any]:
    """Serialize a named-queue fleet to its config-file form."""
    return {"version": SCHEMA_VERSION,
            "queues": {name: scenario_to_json(s)
                       for name, s in fleet.items()}}


def fleet_from_json(obj: Dict[str, Any]) -> Dict[str, Scenario]:
    _require(obj, {"version": True, "queues": True}, "fleet")
    if obj["version"] != SCHEMA_VERSION:
        raise SchemaError("bad_version",
                          f"unsupported fleet version {obj['version']!r}")
    queues = obj["queues"]
    if not isinstance(queues, dict) or not queues:
        raise SchemaError("bad_value",
                          "fleet.queues must be a non-empty object")
    return {name: scenario_from_json(s) for name, s in queues.items()}
