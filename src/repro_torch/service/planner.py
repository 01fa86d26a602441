"""The capacity planner of the PyTorch port: what-if queries against a
fleet of named queues (DESIGN.md §12.2, §20).

Counterpart of ``repro.service.planner``.  :class:`CapacityPlanner` holds a
fleet (``{queue_name: Scenario}``) for the lifetime of a service process
and answers :class:`~repro_torch.service.query.WhatIfQuery` objects by
lowering them onto the port's ``sweep``, on the planner's ``device``
(``cuda`` by default), so every point runs the lockstep ensemble driver
and its batched ``queue_select`` launches:

- every evaluation goes through a ``sweep`` call with at least one axis
  (a single-value ``policy`` axis when nothing varies), so it runs a
  static bucket and is logged in :func:`repro_torch.api.cache_stats`
  against the bucket's signature, as the reference logs its executables;
- a pure ``add_nodes`` grid on a scalar-counter queue is one
  ``total_nodes`` sweep, and a reliability query one ``failures.mtbf`` x
  ``failures.checkpoint_interval`` sweep: one bucket, one batched call;
- a candidate job is appended through :class:`repro_torch.api.
  InjectedTrace`, whose static key is (base key, count), so placement
  queries against one queue share one bucket signature whatever the
  candidate's values.

PyTorch runs eagerly: a "compile" here is a bucket signature seen for the
first time, which costs no more than a repeat (the kernels are built once
a process).  The counts agree with the reference's on the same queries.
``evaluate()`` returns the lowered scenarios beside their Results, so that
each point can be replayed through ``run()``/``run_ref()``; ``answer()``
wraps the same evaluation into the JSON-able response the HTTP layer
ships.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api import Scenario, cache_stats, sweep
from repro_torch.api.result import Result
from repro_torch.core import metrics
from repro_torch.core.jobs import resolve_device

from repro_torch.service.query import (
    Objective, SCHEMA_VERSION, ScenarioDelta, SchemaError, WhatIfQuery,
    apply_delta,
)


class UnknownQueueError(KeyError):
    """Query names a queue the fleet does not have (HTTP 404)."""

    def __init__(self, name: str, known):
        super().__init__(name)
        self.name = name
        self.known = sorted(known)

    def __str__(self):
        return (f"unknown queue {self.name!r}; fleet has "
                f"{self.known}")


def jsonable(obj):
    """Deep-copy with non-finite floats replaced by None: responses go
    through the strict (``allow_nan=False``) canonical encoder, and an
    empty percentile must degrade to ``null``, not a 500."""
    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def enriched_summary(result: Result) -> Dict[str, float]:
    """``Result.summary()`` plus ``p99_wait`` — the planning objective the
    standard summary (p50/p95) lacks.  Serving results already carry an
    exact p99 from ``slo_summary``; batch results get the same
    ``metrics.percentiles`` computation over the canonical wait column."""
    s = result.summary()
    if "p99_wait" not in s:
        out = result.to_np()
        done = (np.asarray(out["valid"], dtype=bool)
                & np.asarray(out["done"], dtype=bool))
        s["p99_wait"] = metrics.percentiles(out["wait"], 99, mask=done)
    return s


def _candidate_row(scn: Scenario) -> int:
    """Sorted-row index of the LAST injected job.

    ``make_jobset`` sorts by (submit, input index), so the appended
    candidate (input row n-1) lands at a deterministic sorted position —
    behind every incumbent sharing its submit time."""
    sub = np.asarray(scn.trace.materialize()["submit"])
    n = len(sub)
    order = np.lexsort((np.arange(n), sub))
    return int(np.nonzero(order == n - 1)[0][0])


def candidate_outcome(scn: Scenario, result: Result) -> Dict[str, Any]:
    """The injected candidate's row metrics from a placement point."""
    row = _candidate_row(scn)
    out = result.to_np()
    started = bool(out["done"][row]) and bool(out["valid"][row])
    return {
        "row": row,
        "start": int(out["start"][row]),
        "finish": int(out["finish"][row]),
        "wait": int(out["wait"][row]),
        "started": started,
    }


def _single_point(scn: Scenario, device) -> Result:
    """Run one scenario through the batched bucket path (B=1).

    ``sweep(s, axes={})`` degenerates to ``run()`` and would bypass the
    bucket signatures; a single-value ``policy`` axis is the universal
    no-op axis (every scenario has a policy) that keeps the service on
    the ensemble driver and on the cache statistics.
    """
    return sweep(scn, axes={"policy": (scn.policy,)},
                 device=device).results[0]


class CapacityPlanner:
    """Long-running what-if answerer over a fleet of named queues.

    ``device`` is where every evaluation runs: ``None`` means ``cuda``,
    which raises without a card, as ``sweep`` does; CPU callers pass
    ``"cpu"``.
    """

    def __init__(self, fleet: Dict[str, Scenario], device=None):
        if not fleet:
            raise SchemaError("bad_value", "fleet has no queues")
        self.fleet: Dict[str, Scenario] = dict(fleet)
        self.device = resolve_device(device)
        self._status: Dict[str, Dict[str, float]] = {}
        # one query at a time: evaluation updates the process-wide cache
        # statistics and launch counters, and interleaved queries would
        # misattribute their deltas
        self._lock = threading.Lock()

    # -- fleet ---------------------------------------------------------------

    def queue(self, name: Optional[str]) -> Tuple[str, Scenario]:
        if name is None:
            if len(self.fleet) == 1:
                return next(iter(self.fleet.items()))
            raise SchemaError(
                "missing_field", f"query names no queue and the fleet has "
                f"{len(self.fleet)}; set 'queue'")
        if name not in self.fleet:
            raise UnknownQueueError(name, self.fleet)
        return name, self.fleet[name]

    def baseline_summary(self, name: str) -> Dict[str, float]:
        """The queue's as-is summary (cached for the planner's lifetime —
        the fleet is immutable once loaded)."""
        if name not in self._status:
            _, scn = self.queue(name)
            self._status[name] = enriched_summary(
                _single_point(scn, self.device))
        return dict(self._status[name])

    def fleet_status(self) -> Dict[str, Any]:
        """Per-queue baseline metrics — the service's aggregate dashboard."""
        with self._lock:
            queues = {}
            for name, scn in self.fleet.items():
                queues[name] = {
                    "total_nodes": int(np.sum(scn.nodes_per_cluster())),
                    "policy": str(scn.policy),
                    "topology": (None if scn.topology is None
                                 else scn.topology.kind),
                    "failures": scn.failures is not None,
                    "summary": self.baseline_summary(name),
                }
            c = cache_stats()
            return jsonable(
                {"version": SCHEMA_VERSION, "queues": queues,
                 "cache": {"compiles": c.compiles, "hits": c.hits,
                           "entries": c.entries}})

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, query: WhatIfQuery) -> List[Dict[str, Any]]:
        """Lower a query to scenarios, run them, return grid-ordered points.

        Each point dict carries ``label``, ``queue``, the lowered
        ``scenario`` (what the differential harness replays through
        ``run()``/``run_ref()``), its ``result``, and per-kind metadata
        (``delta`` / ``mtbf`` / ``checkpoint_interval`` / ``candidate``).
        """
        with self._lock:
            return self._evaluate_locked(query)

    def _evaluate_locked(self, query: WhatIfQuery) -> List[Dict[str, Any]]:
        if query.kind == "placement":
            return self._eval_placement(query)
        if query.kind == "capacity":
            return self._eval_capacity(query)
        return self._eval_reliability(query)

    def _eval_placement(self, query: WhatIfQuery) -> List[Dict[str, Any]]:
        names = query.queues
        if names is None:
            names = tuple(self.fleet)
        points = []
        for name in names:
            name, base = self.queue(name)
            job = query.job
            if job.nodes > int(np.sum(base.nodes_per_cluster())):
                # make_jobset would silently clamp the request; an answer
                # computed from a clamped job is not the job the user asked
                # about, so the queue is reported infeasible instead
                points.append({
                    "label": name, "queue": name, "scenario": None,
                    "result": None, "candidate": None,
                    "infeasible": f"job needs {job.nodes} nodes; queue "
                                  f"has {base.total_nodes}",
                })
                continue
            delta = ScenarioDelta(inject=(job,))
            scn = apply_delta(base, delta)
            res = _single_point(scn, self.device)
            points.append({
                "label": name, "queue": name, "scenario": scn,
                "result": res, "candidate": candidate_outcome(scn, res),
                "infeasible": None,
            })
        return points

    def _eval_capacity(self, query: WhatIfQuery) -> List[Dict[str, Any]]:
        name, base = self.queue(query.queue)
        scenarios = [apply_delta(base, d) for d in query.deltas]
        # a pure add_nodes grid on a scalar-counter queue is sweep data:
        # ONE bucket runs every delta (DESIGN.md §12.2)
        nodes_only = base.topology is None and all(
            d == ScenarioDelta(add_nodes=d.add_nodes) for d in query.deltas)
        if nodes_only and len(query.deltas) > 1:
            grid = sweep(base, axes={
                "total_nodes": tuple(int(s.total_nodes) for s in scenarios)},
                device=self.device)
            results = list(grid.results)
        else:
            results = [_single_point(s, self.device) for s in scenarios]
        return [{
            "label": d.describe(), "queue": name, "scenario": s,
            "result": r, "delta": d,
            "candidate": (candidate_outcome(s, r) if d.inject else None),
        } for d, s, r in zip(query.deltas, scenarios, results)]

    def _eval_reliability(self, query: WhatIfQuery) -> List[Dict[str, Any]]:
        name, base = self.queue(query.queue)
        if base.failures is None:
            raise SchemaError(
                "unsupported", f"queue {name!r} carries no FailureModel; "
                "reliability queries need a failures= spec on the base "
                "scenario")
        axes: Dict[str, tuple] = {"failures.mtbf": query.mtbf_grid}
        if query.checkpoint_grid:
            axes["failures.checkpoint_interval"] = query.checkpoint_grid
        grid = sweep(base, axes=axes, device=self.device)
        points = []
        for point, res in grid:
            mtbf = float(point["failures.mtbf"])
            ckpt = point.get("failures.checkpoint_interval")
            label = f"mtbf={mtbf:g}"
            if ckpt is not None:
                label += f", ckpt={int(ckpt)}"
            points.append({
                "label": label, "queue": name,
                "scenario": base.with_(**point), "result": res,
                "mtbf": mtbf,
                "checkpoint_interval": None if ckpt is None else int(ckpt),
            })
        return points

    # -- answers -------------------------------------------------------------

    def answer(self, query: WhatIfQuery) -> Dict[str, Any]:
        """The JSON-able response for one query (module docstring).

        The whole answer holds the planner's lock, so the ``cache`` deltas
        it reports are its own evaluation's even when handler threads ask
        at once (the reference reads them outside its lock).
        """
        with self._lock:
            return self._answer_locked(query)

    def _answer_locked(self, query: WhatIfQuery) -> Dict[str, Any]:
        before = cache_stats()
        points = self._evaluate_locked(query)
        objective = query.default_objective()
        rows = []
        out_points = []
        for p in points:
            entry: Dict[str, Any] = {"label": p["label"],
                                     "queue": p["queue"]}
            if p.get("delta") is not None:
                entry["delta"] = p["delta"].to_json_dict()
            for k in ("mtbf", "checkpoint_interval"):
                if k in p:
                    entry[k] = p[k]
            if p.get("infeasible"):
                entry["infeasible"] = p["infeasible"]
                out_points.append(entry)
                continue
            summ = enriched_summary(p["result"])
            if p.get("candidate") is not None:
                entry["candidate"] = p["candidate"]
                summ["candidate_wait"] = (
                    float(p["candidate"]["wait"])
                    if p["candidate"]["started"] else float("nan"))
            entry["summary"] = summ
            rows.append((p["label"], summ))
            out_points.append(entry)
        if not rows:
            raise SchemaError(
                "unsupported", "no feasible evaluation point (every "
                "candidate queue was too small for the job)")

        baseline = None
        if query.kind in ("capacity", "reliability"):
            baseline = self.baseline_summary(points[0]["queue"])
        try:
            recs = metrics.rank_candidates(
                rows, objective.metric, goal=objective.goal,
                baseline=baseline, target=objective.target)
        except KeyError as e:
            raise SchemaError("bad_value", str(e))

        # with a target, "recommended" is the first candidate IN INPUT
        # ORDER meeting it (input order encodes the asker's cost
        # preference: cheapest deltas first); without one, the best-ranked
        recommended = None
        if objective.target is not None:
            by_label = {r["label"]: r for r in recs}
            for label, _ in rows:
                if by_label[label].get("meets_target"):
                    recommended = label
                    break
        elif recs:
            recommended = recs[0]["label"]

        after = cache_stats()
        return jsonable({
            "version": SCHEMA_VERSION,
            "kind": query.kind,
            "queue": query.queue,
            "objective": objective.to_json_dict(),
            "baseline": baseline,
            "points": out_points,
            "recommendations": recs,
            "recommended": recommended,
            "cache": {"compiles": after.compiles - before.compiles,
                      "hits": after.hits - before.hits,
                      "entries": after.entries},
        })
