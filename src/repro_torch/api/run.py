"""The entry points of the PyTorch port: ``run(scenario) -> Result`` on the
engine (one cluster, or the conservative-window multicluster engine), and
``run_ref(scenario) -> Result`` on the host oracle
(``repro_torch.refsim``) from the *same* spec, so that

    run(s).matches(run_ref(s))

validates a single-cluster run in one line, on any scenario and without
JAX."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch import alloc as _alloc
from repro_torch.api.result import Result
from repro_torch.api.scenario import Scenario
from repro_torch.core import engine
from repro_torch.core.jobs import (
    POLICY_NAMES, JobSet, make_jobset, resolve_device,
)
from repro_torch.core.parallel import simulate_multicluster, stack_jobsets


def build_jobset(scenario: Scenario, *, cluster: int = 0,
                 capacity: Optional[int] = None, device=None) -> JobSet:
    """Materialize one cluster's trace into a ``JobSet`` on ``device``
    (``cuda`` by default).  A ``ServiceTrace`` pads the table to its
    ``max_jobs`` when no capacity is given, so its deadline and class
    columns stay row-aligned with the table at every rate."""
    spec = scenario.trace_specs()[cluster]
    trace = spec.materialize()
    if capacity is None:
        capacity = scenario.capacity
    if capacity is None:
        capacity = getattr(spec, "pad_capacity", None)
    return make_jobset(
        trace["submit"], trace["runtime"], trace["nodes"],
        trace.get("estimate"), trace.get("priority"),
        deps=trace.get("deps"),
        capacity=capacity,
        total_nodes=scenario.nodes_per_cluster()[cluster],
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
    spec = scenario.trace_specs()[0]
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
    if scenario.multicluster is not None:
        return _run_multicluster(scenario, device)
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


def run_ref(scenario: Scenario) -> Result:
    """Run the same spec on the host reference simulator, the engine's
    bit-exact twin, fed the same materialized failure trace, service plan
    and malleable plan as ``run``.  Host code by design: it never touches a
    device, and no run of the engine falls back to it."""
    from repro_torch.refsim import simulate_reference

    if scenario.multicluster is not None:
        raise ValueError(
            "the reference simulator has no multicluster mode; validate the "
            "single-cluster scenario per cluster instead")
    policy = scenario.policy
    policy = (policy.lower() if isinstance(policy, str)
              else POLICY_NAMES[int(policy)])
    alloc_name = ("simple" if scenario.alloc is None
                  else _alloc.ALLOC_NAMES[_alloc.canonical_id(scenario.alloc)])
    out = simulate_reference(
        scenario.trace.materialize(), policy,
        total_nodes=int(scenario.total_nodes),
        machine=build_machine(scenario, "cpu"),
        alloc=alloc_name,
        contention=scenario.contention,
        failures=_failure_trace(scenario),
        service=_service_plan(scenario),
        malleable=_mal_plan(scenario),
    )
    return Result(scenario=scenario, raw=out, backend="ref")


# ---------------------------------------------------------------------------
# multicluster
# ---------------------------------------------------------------------------


def _multicluster_capacity(scenario: Scenario, traces: Tuple[dict, ...]
                           ) -> int:
    """One row capacity for every cluster: the largest cluster plus room
    for imported jobs (``8 * max_export`` with migration)."""
    if scenario.capacity is not None:
        return scenario.capacity
    biggest = max(len(t["submit"]) for t in traces)
    mc = scenario.multicluster
    return biggest + (8 * mc.max_export if mc.migrate else 0)


def _default_horizon(traces, nodes_c, window: int) -> int:
    """The migration rounds' horizon when the spec leaves it ``None``: the
    worst cluster's submission span plus its drain bound (``ceil(sum(nodes
    x runtime) / total_nodes)``, at least twice the longest job), plus two
    windows.  Events past the horizon still happen; they only stop
    triggering migration."""
    worst = 0
    for t, n in zip(traces, nodes_c):
        sub = np.asarray(t["submit"])
        rt = np.maximum(np.asarray(t["runtime"]), 1)
        est = np.asarray(t["estimate"]) if "estimate" in t else rt
        span = int(sub.max(initial=0) - sub.min(initial=0))
        nodes = np.clip(np.asarray(t["nodes"]), 1, n)
        drain = -(-int(np.sum(nodes * rt)) // int(n))
        tail = max(drain, 2 * int(max(rt.max(initial=1), est.max(initial=1))))
        worst = max(worst, span + tail)
    return worst + 2 * window


def multicluster_args(scenario: Scenario, device) -> tuple:
    """The arguments ``run`` gives ``simulate_multicluster`` for a
    multicluster scenario: ``(jobs_c, policy, nodes_c, kwargs)``, the
    clusters' tables at one capacity, stacked (a table without edges gets
    pad edges when another has some), on ``device``.  A caller adds
    ``mesh=`` to shard the clusters."""
    if scenario.topology is not None:
        raise ValueError(
            "multicluster scenarios run scalar-counter clusters; "
            "per-cluster topologies are not supported yet")
    mc = scenario.multicluster
    nodes_c = scenario.nodes_per_cluster()
    traces = tuple(s.materialize() for s in scenario.trace_specs())
    cap = _multicluster_capacity(scenario, traces)
    jobsets = [
        make_jobset(t["submit"], t["runtime"], t["nodes"], t.get("estimate"),
                    t.get("priority"), deps=t.get("deps"), capacity=cap,
                    total_nodes=n, device=device)
        for t, n in zip(traces, nodes_c)]
    horizon = mc.horizon
    if horizon is None:
        horizon = _default_horizon(traces, nodes_c, int(mc.window))
    return (stack_jobsets(jobsets), scenario.policy, nodes_c,
            dict(window=int(mc.window), horizon=horizon, migrate=mc.migrate,
                 max_export=mc.max_export, latency=mc.latency,
                 load_imbalance_threshold=mc.load_imbalance_threshold,
                 max_events=scenario.max_events))


def _run_multicluster(scenario: Scenario, device) -> Result:
    """One multicluster scenario through ``simulate_multicluster``."""
    jobs_c, policy, nodes_c, kw = multicluster_args(scenario, device)
    res = simulate_multicluster(jobs_c, policy, nodes_c, device=device, **kw)
    return Result(scenario=scenario, raw=res, backend="multicluster")
