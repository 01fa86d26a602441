"""Result wrapper of the PyTorch port.

Counterpart of ``repro.api.result``: ``to_np()`` gives the reference's
canonical numpy dict (``submit``, ``nodes``, ``runtime``, ``start``,
``finish``, ``ready``, ``wait``, ``makespan``, ``n_events``, ``done``,
``valid``, plus ``alloc_first``/``alloc_span``/``alloc_sum`` and the
``ev_*`` log cut to ``n_events`` when the scenario has a topology, the
reliability columns ``n_restarts``/``lost_work``/``aborted`` with a failure
model, and the serving columns ``slo_met``/``deadline``/``class_id`` and the
capacity log ``cap_online``/``cap_time`` with a ``ServiceTrace``), so the
two engines' results compare key by key, and ``summary()`` derives the same
scalar metrics.  ``ready`` is ``max(submit, last dependency's finish)`` and
``wait`` is ``start - ready``, the paper's Fig. 7 workflow wait (``start -
submit`` for a job without dependencies).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.api.scenario import Scenario
from repro_torch.core import metrics
from repro_torch.core.jobs import ALLOC_FIELDS, EV_FIELDS, JobSet, SimResult


@dataclasses.dataclass
class Result:
    """One simulation outcome: the scenario, the engine's ``SimResult``
    (``raw``, tensors on the run's device) and its job table.  A member of
    an ensemble or a sweep holds its row of the batched result
    (``SimResult.member``) and its member table (``JobSet.member``)."""

    scenario: Scenario
    raw: SimResult
    jobs: JobSet
    _np: Optional[Dict[str, np.ndarray]] = dataclasses.field(
        default=None, repr=False)

    def to_np(self) -> Dict[str, np.ndarray]:
        """Canonical host-side result dict (cached)."""
        if self._np is None:
            self._np = simresult_to_np(
                self.raw, self.jobs,
                with_alloc=self.scenario.topology is not None,
                service=self._service_plan())
        return self._np

    def _service_plan(self):
        spec = self.scenario.trace
        return spec.plan() if hasattr(spec, "plan") else None

    def __getitem__(self, key: str) -> np.ndarray:
        return self.to_np()[key]

    def summary(self) -> Dict[str, float]:
        """n_jobs, wait statistics, bounded slowdown, makespan,
        utilization and throughput, plus the job-span and fragmentation
        scalars when the scenario has a topology, the reliability scalars
        with a failure model and the SLO scalars with a
        ``ServiceTrace``."""
        out = self.to_np()
        total = int(self.scenario.total_nodes)
        s = metrics.summary(out, total)
        if "ev_time" in out and "alloc_span" in out:
            s.update(metrics.alloc_summary(out))
        if "n_restarts" in out:
            s.update(metrics.reliability_summary(out))
        if "slo_met" in out:
            plan = self._service_plan()
            s.update(metrics.slo_summary(
                out, class_names=None if plan is None else plan.class_names,
                total_nodes=total))
        return s

    @property
    def makespan(self) -> int:
        return int(self.to_np()["makespan"])

    def matches(self, other, *, node_maps: bool = False) -> bool:
        """Bit-exact start/finish (and with ``node_maps`` allocation
        fingerprint) agreement with another result (of either engine) over
        the shorter table."""
        a, b = self.to_np(), other.to_np()
        n = min(int(a["valid"].sum()), int(b["valid"].sum()))
        keys = ["start", "finish"]
        if node_maps:
            keys += ["alloc_first", "alloc_span", "alloc_sum"]
        return all(bool(np.array_equal(a[k][:n], b[k][:n])) for k in keys)


def simresult_to_np(res: SimResult, jobs: JobSet, *,
                    with_alloc: bool = False,
                    service=None) -> Dict[str, np.ndarray]:
    """``SimResult`` + ``JobSet`` -> the canonical numpy dict.
    ``service`` (the run's ``ServicePlan``) adds ``class_id`` and the
    ticks' times ``cap_time``."""
    out = {
        "submit": jobs.submit.cpu().numpy(),
        "nodes": jobs.nodes.cpu().numpy(),
        "runtime": jobs.runtime.cpu().numpy(),
        "start": res.start.cpu().numpy(),
        "finish": res.finish.cpu().numpy(),
        "ready": res.ready.cpu().numpy(),
        "wait": res.wait.cpu().numpy(),
        "makespan": int(res.makespan),
        "n_events": int(res.n_events),
        "done": res.done.cpu().numpy(),
        "valid": jobs.valid.cpu().numpy(),
    }
    if with_alloc:
        n_ev = out["n_events"]
        for k in ALLOC_FIELDS:
            out[k] = getattr(res, k).cpu().numpy()
        for k in EV_FIELDS:
            out[k] = getattr(res, k).cpu().numpy()[:n_ev]
    if res.rel is not None:
        for k in ("n_restarts", "lost_work", "aborted"):
            out[k] = getattr(res.rel, k).cpu().numpy()
    if res.svc is not None:
        out["slo_met"] = res.svc.slo_met.cpu().numpy()
        out["deadline"] = res.svc.deadline.cpu().numpy()
        # the online level per consumed tick (-1: never consumed); the
        # ticks' times come from the plan's stream
        cap = res.svc.cap_online.cpu().numpy()
        used = cap >= 0
        out["cap_online"] = cap[used].astype(np.int64)
        if service is not None:
            out["class_id"] = np.asarray(service.class_id, dtype=np.int64)
            out["cap_time"] = np.asarray(service.tick_time,
                                         dtype=np.int64)[used]
    return out
