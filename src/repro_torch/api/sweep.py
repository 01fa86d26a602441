"""Multi-axis scenario sweeps of the PyTorch port (DESIGN.md §12.2).

Counterpart of ``repro.api.sweep`` for the ported fields.
``sweep(scenario, axes={...})`` expands a cartesian grid of dotted-path
axes over a base :class:`Scenario`:

1. every grid point becomes a scenario via ``Scenario.with_``;
2. points are partitioned into *static buckets*, keyed on what fixes the
   stacked table's shape: the trace's static key (everything but its
   seed; for a ``ServiceTrace`` its ``max_jobs`` and the autoscaler's
   ``max_ticks``), the topology (and ``total_nodes`` with it),
   ``capacity``, ``max_events``, the failure model's ``max_failures`` and
   the malleable model's width range, mode and tick capacity, as the
   reference keys them (a workflow DAG's seed axis stays in one
   bucket even where its edge counts differ: ``stack_jobsets`` pads the
   edge lists);
3. within a bucket the remaining axes (``policy``, ``alloc``,
   ``contention``, ``total_nodes`` without a topology, ``trace.seed``, the
   failure model's other fields, the service's rate, classes and
   autoscaler, the malleable model's curve, parameters, interval, step and
   thresholds) are data: the members' job tables are stacked, each member
   gets its own failure stream, service plan and malleable plan, and ONE
   batched ``simulate_ensemble`` call runs the whole bucket;
4. the batched result is sliced into per-point :class:`Result`\\ s in grid
   order.

A multicluster scenario's every setting is static (the clusters' node
counts too), so its buckets run point by point through ``run``, as the
reference's do.

**What "compile once" means here.**  PyTorch runs eagerly, so there is no
executable to compile: a static bucket is one batched ``simulate_ensemble``
call, whatever its number of points, and ``SweepResult.n_compiles`` counts
the buckets, as the reference's counts its executables, so the two agree on
the same grid.  The CUDA kernels are built once a process
(``kernels/_build.py``) and loaded once.  ``cache_stats`` logs every bucket
execution against its signature, as the reference logs its executions
against its compile signature: the bucket key, the policy and the strategy
when every point of the bucket shares one (the reference bakes such a
value into its executable), and the stacked tensors' shapes and dtypes.  A
new signature counts as a ``compile``, a seen one as a ``hit``, so that the
what-if service (``repro_torch.service``) can assert that a repeated query
reuses its bucket.  No CUDA
graphs are captured.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import alloc as _alloc
from repro_torch.api.result import Result
from repro_torch.api.run import (
    _failure_trace, _mal_plan, _service_plan, build_jobset, build_machine,
    run,
)
from repro_torch.api.scenario import Scenario
from repro_torch.core import engine
from repro_torch.core.jobs import JOB_FIELDS, JobSet, resolve_device
from repro_torch.core.parallel import simulate_ensemble, stack_jobsets


def _static_key(scenario: Scenario) -> tuple:
    """Hashable bucket key: everything that fixes the stacked shapes.
    ``total_nodes`` is data in scalar-counter mode, and static with a
    topology, which pins the machine, or with multicluster, which pins
    the clusters.  A failure model adds only its padded capacity, a
    malleable model its width range, mode and tick capacity; every
    multicluster setting is static."""
    pinned = (scenario.topology is not None
              or scenario.multicluster is not None)
    return (tuple(t.static_key() for t in scenario.trace_specs()),
            scenario.topology,
            scenario.total_nodes if pinned else None,
            scenario.multicluster,
            scenario.capacity, scenario.max_events,
            None if scenario.failures is None
            else scenario.failures.static_key(),
            None if scenario.malleable is None
            else scenario.malleable.static_key())


@dataclasses.dataclass
class SweepResult:
    """Grid-ordered sweep outcome.

    ``points[i]`` is the axis-value dict of grid point *i* and
    ``results[i]`` its :class:`Result`; iteration yields ``(point,
    result)`` pairs.  ``summaries()`` flattens to a list of plain dicts
    (axis values + scalar metrics) ready for CSV emission, and
    ``stack(field)`` restacks one per-job array across the whole grid.
    ``n_compiles`` reports how many static buckets (batched calls) the
    sweep needed.
    """

    axes: Dict[str, List[Any]]
    points: List[Dict[str, Any]]
    results: List[Result]
    n_compiles: int

    def __len__(self) -> int:
        return len(self.points)

    def __iter__(self) -> Iterator[Tuple[Dict[str, Any], Result]]:
        return iter(zip(self.points, self.results))

    def __getitem__(self, i: int) -> Result:
        return self.results[i]

    def get(self, **coords) -> Result:
        """The unique result whose point matches every given axis value."""
        hits = [r for p, r in self if all(p[k] == v for k, v in coords.items())]
        if len(hits) != 1:
            raise KeyError(f"{coords} matches {len(hits)} grid points")
        return hits[0]

    def summaries(self) -> List[Dict[str, Any]]:
        return [{**p, **r.summary()} for p, r in self]

    def stack(self, field: str) -> np.ndarray:
        return np.stack([r.to_np()[field] for r in self.results])


def sweep(scenario: Scenario, axes: Dict[str, Sequence[Any]], *,
          mesh=None, device=None) -> SweepResult:
    """Run the cartesian grid of ``axes`` over ``scenario`` (module doc).

    ``axes`` maps dotted scenario paths to value sequences, e.g.::

        sweep(s, axes={"policy": ("fcfs", "backfill"),
                       "total_nodes": (128, 256),
                       "trace.seed": (0, 1)})

    ``device=None`` runs on ``cuda`` and raises without one.  ``mesh``
    (sharding the buckets over several cards) is not ported yet.
    """
    if mesh is not None:
        raise NotImplementedError(
            "sweep(mesh=...) is not ported yet: ROADMAP Queue 1 item 12 "
            "(ensembles over several cards)")
    device = resolve_device(device)
    axes = {k: list(v) for k, v in axes.items()}
    if not axes:
        return SweepResult(axes={}, points=[{}],
                           results=[run(scenario, device=device)],
                           n_compiles=1)
    names = list(axes)
    points = [dict(zip(names, combo))
              for combo in itertools.product(*axes.values())]

    buckets: Dict[tuple, List[int]] = {}
    scenarios: List[Scenario] = []
    for i, point in enumerate(points):
        scn = scenario.with_(**point)
        scenarios.append(scn)
        buckets.setdefault(_static_key(scn), []).append(i)

    results: List[Optional[Result]] = [None] * len(points)
    for key, indices in buckets.items():
        bucket = [scenarios[i] for i in indices]
        if bucket[0].multicluster is not None:
            # every multicluster setting is static: one run a point
            for i, scn in zip(indices, bucket):
                results[i] = run(scn, device=device)
            continue
        for i, res in zip(indices, _run_bucket(key, bucket, device)):
            results[i] = res
    return SweepResult(axes=axes, points=points, results=results,
                       n_compiles=len(buckets))


# ---------------------------------------------------------------------------
# public cache statistics (DESIGN.md §20)
# ---------------------------------------------------------------------------

_CACHE_LOG = {"compiles": 0, "hits": 0}
_SEEN_SIGNATURES: set = set()


@dataclasses.dataclass(frozen=True)
class SweepCacheStats:
    """Counters of the sweep's bucket executions.

    ``compiles`` counts executions whose signature had not been seen since
    the last ``reset_cache_stats(clear=True)``; ``hits`` counts executions
    of a known signature.  ``entries`` is the number of distinct
    signatures seen.
    """

    compiles: int
    hits: int
    entries: int


def cache_stats() -> SweepCacheStats:
    """Current counters of the sweep's bucket executions."""
    return SweepCacheStats(compiles=_CACHE_LOG["compiles"],
                           hits=_CACHE_LOG["hits"],
                           entries=len(_SEEN_SIGNATURES))


def reset_cache_stats(*, clear: bool = False) -> None:
    """Zero the counters.  With ``clear=True`` the seen signatures are
    dropped too, so the next execution of every bucket counts as a
    ``compile`` again."""
    _CACHE_LOG["compiles"] = 0
    _CACHE_LOG["hits"] = 0
    if clear:
        _SEEN_SIGNATURES.clear()


def _uniform(values):
    """The one value of ``values``, or ``None`` when they differ."""
    return values[0] if len(set(values)) == 1 else None


def _log_bucket_execution(key: tuple, bucket: List[Scenario],
                          jobs_b: JobSet) -> None:
    pols = [engine.policies_id(s.policy) for s in bucket]
    allocs = ([_alloc.canonical_id(s.alloc) for s in bucket]
              if bucket[0].topology is not None else [None])
    sig = (key, _uniform(pols), _uniform(allocs),
           tuple((f, tuple(getattr(jobs_b, f).shape),
                  str(getattr(jobs_b, f).dtype)) for f in JOB_FIELDS
                 if getattr(jobs_b, f) is not None))
    if sig in _SEEN_SIGNATURES:
        _CACHE_LOG["hits"] += 1
    else:
        _SEEN_SIGNATURES.add(sig)
        _CACHE_LOG["compiles"] += 1


def _run_bucket(key: tuple, bucket: List[Scenario], device) -> List[Result]:
    """One batched ``simulate_ensemble`` call for all scenarios of a static
    bucket."""
    jobs_cache: Dict[tuple, JobSet] = {}
    jobsets = []
    for scn in bucket:
        spec = scn.trace_specs()[0]
        # key on the full spec (every spec is hashable; ArrayTrace by
        # identity): two points of one bucket may still differ in trace
        # data (the seed), and node requests are clamped to total_nodes
        cache_key = (spec, int(scn.total_nodes))
        if cache_key not in jobs_cache:
            jobs_cache[cache_key] = build_jobset(scn, device=device)
        jobsets.append(jobs_cache[cache_key])
    jobs_b = stack_jobsets(jobsets)
    _log_bucket_execution(key, bucket, jobs_b)
    machine = build_machine(bucket[0], device)
    kw = {}
    if machine is not None:
        kw = {"machine": machine,
              "alloc_b": [s.alloc for s in bucket],
              "contention": [s.contention for s in bucket]}
    if bucket[0].failures is not None:
        kw["failures_b"] = [_failure_trace(s) for s in bucket]
    if _service_plan(bucket[0]) is not None:
        kw["service_b"] = [_service_plan(s) for s in bucket]
    if bucket[0].malleable is not None:
        kw["malleable_b"] = [_mal_plan(s) for s in bucket]
    batched = simulate_ensemble(
        jobs_b, [s.policy for s in bucket],
        [int(s.total_nodes) for s in bucket],
        max_events=bucket[0].max_events, device=device, **kw)
    return [Result(scenario=scn, raw=batched.member(b), jobs=jobs_b.member(b))
            for b, scn in enumerate(bucket)]
