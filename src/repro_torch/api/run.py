"""The entry point of the PyTorch port: ``run(scenario) -> Result``."""

from __future__ import annotations

from typing import Optional

from repro_torch.api.result import Result
from repro_torch.api.scenario import Scenario
from repro_torch.core import engine
from repro_torch.core.jobs import JobSet, make_jobset, resolve_device


def build_jobset(scenario: Scenario, *, capacity: Optional[int] = None,
                 device=None) -> JobSet:
    """Materialize the scenario's trace into a ``JobSet`` on ``device``
    (``cuda`` by default).  A ``ServiceTrace`` pads the table to its
    ``max_jobs`` when no capacity is given, so its deadline and class
    columns stay row-aligned with the table at every rate."""
    trace = scenario.trace.materialize()
    if capacity is None:
        capacity = scenario.capacity
    if capacity is None:
        capacity = getattr(scenario.trace, "pad_capacity", None)
    return make_jobset(
        trace["submit"], trace["runtime"], trace["nodes"],
        trace.get("estimate"), trace.get("priority"),
        deps=trace.get("deps"),
        capacity=capacity,
        total_nodes=int(scenario.total_nodes),
        device=device,
    )


def build_machine(scenario: Scenario, device=None):
    """The scenario's machine on ``device``, or ``None`` without a
    topology."""
    if scenario.topology is None:
        return None
    return scenario.topology.build(device)


def _failure_trace(scenario: Scenario):
    """The scenario's one materialized failure trace (the model's lru
    cache keeps every call on the same arrays), or ``None``."""
    if scenario.failures is None:
        return None
    return scenario.failures.materialize(int(scenario.total_nodes))


def _service_plan(scenario: Scenario):
    """The scenario's one materialized serving plan (the spec's lru
    cache), or ``None`` when its trace is no ``ServiceTrace``."""
    spec = scenario.trace
    return spec.plan() if hasattr(spec, "plan") else None


def _mal_plan(scenario: Scenario):
    """The scenario's malleable plan, materialized once against its trace
    at the table's padded capacity (so the plan's rows align with the job
    table's), or ``None`` without a malleable model."""
    if scenario.malleable is None:
        return None
    from repro_torch.malleable import materialize_plan

    capacity = scenario.capacity
    if capacity is None:
        capacity = getattr(scenario.trace, "pad_capacity", None)
    return materialize_plan(scenario.malleable, scenario.trace.materialize(),
                            total_nodes=int(scenario.total_nodes),
                            capacity=capacity)


def run(scenario: Scenario, device=None) -> Result:
    """Run one scenario on the PyTorch engine.  ``device=None`` runs on
    ``cuda`` and raises when there is none; pass ``device="cpu"`` for the
    plain PyTorch path."""
    device = resolve_device(device)
    jobs = build_jobset(scenario, device=device)
    res = engine.simulate(jobs, scenario.policy, int(scenario.total_nodes),
                          machine=build_machine(scenario, device),
                          alloc=scenario.alloc,
                          contention=scenario.contention,
                          failures=_failure_trace(scenario),
                          service=_service_plan(scenario),
                          malleable=_mal_plan(scenario),
                          max_events=scenario.max_events, device=device)
    return Result(scenario=scenario, raw=res, jobs=jobs)
