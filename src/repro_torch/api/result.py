"""Result wrapper of the PyTorch port.

Counterpart of ``repro.api.result``, for the port's engine (``run``) and its
host oracle (``run_ref``) alike: ``to_np()`` gives the reference's
canonical numpy dict (``submit``, ``nodes``, ``runtime``, ``start``,
``finish``, ``ready``, ``wait``, ``makespan``, ``n_events``, ``done``,
``valid``, plus ``alloc_first``/``alloc_span``/``alloc_sum`` and the
``ev_*`` log cut to ``n_events`` when the scenario has a topology, the
reliability columns ``n_restarts``/``lost_work``/``aborted`` with a failure
model, and the serving columns ``slo_met``/``deadline``/``class_id`` and the
capacity log ``cap_online``/``cap_time`` with a ``ServiceTrace``, and the
malleable columns ``mal_width``/``mal_nref``/``mal_nresize``/``mal_node_s``/
``mal_dur`` with a ``MalleableModel``), so the two engines' results compare
key by key, and ``summary()`` derives the same
scalar metrics.  ``ready`` is ``max(submit, last dependency's finish)`` and
``wait`` is ``start - ready``, the paper's Fig. 7 workflow wait (``start -
submit`` for a job without dependencies).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np

from repro_torch.api.scenario import Scenario
from repro_torch.core import metrics
from repro_torch.core.jobs import ALLOC_FIELDS, EV_FIELDS, JobSet, SimResult
from repro_torch.core.parallel import multicluster_result_np


@dataclasses.dataclass
class Result:
    """One simulation outcome, of any backend.

    ``backend`` is ``"torch"`` (the port's engine: ``raw`` its
    ``SimResult``, tensors on the run's device, and ``jobs`` its job table),
    ``"multicluster"`` (the multicluster engine: ``raw`` its
    ``MulticlusterResult``, ``to_np()`` its ``multicluster_result_np``) or
    ``"ref"`` (the host oracle, ``run_ref``: ``raw`` its numpy dict,
    ``jobs`` ``None``).  A member of an ensemble or a sweep holds its row of
    the batched result (``SimResult.member``) and its member table
    (``JobSet.member``)."""

    scenario: Scenario
    raw: Union[SimResult, Dict[str, Any]]
    jobs: Optional[JobSet] = None
    backend: str = "torch"
    _np: Optional[Dict[str, np.ndarray]] = dataclasses.field(
        default=None, repr=False)

    def to_np(self) -> Dict[str, np.ndarray]:
        """Canonical host-side result dict (cached)."""
        if self._np is None:
            if self.backend == "ref":
                self._np = dict(self.raw)
            elif self.backend == "multicluster":
                self._np = multicluster_result_np(self.raw)
            else:
                self._np = simresult_to_np(
                    self.raw, self.jobs,
                    with_alloc=self.scenario.topology is not None,
                    service=self._service_plan())
        return self._np

    def _service_plan(self):
        spec = self.scenario.trace_specs()[0]
        return spec.plan() if hasattr(spec, "plan") else None

    def __getitem__(self, key: str) -> np.ndarray:
        return self.to_np()[key]

    def summary(self) -> Dict[str, float]:
        """n_jobs, wait statistics, bounded slowdown, makespan,
        utilization and throughput, plus the job-span and fragmentation
        scalars when the scenario has a topology, the reliability scalars
        with a failure model, the SLO scalars with a ``ServiceTrace`` and
        the malleable scalars with a ``MalleableModel``; over the clusters'
        summed nodes for a multicluster run."""
        out = self.to_np()
        total = int(np.sum(self.scenario.nodes_per_cluster()))
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
        if "mal_width" in out:
            s.update(metrics.malleable_summary(out))
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
    if res.mal is not None:
        # final width, reference width, resizes, node-second ledger and
        # the dilated duration chosen at dispatch, row-aligned
        for k, f in (("mal_width", "width"), ("mal_nref", "nref"),
                     ("mal_nresize", "n_resizes"), ("mal_node_s", "node_s"),
                     ("mal_dur", "disp_dur")):
            out[k] = getattr(res.mal, f).cpu().numpy().astype(np.int64)
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
