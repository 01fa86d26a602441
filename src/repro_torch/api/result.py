"""Result wrapper of the PyTorch port.

Counterpart of ``repro.api.result``: ``to_np()`` gives the reference's
canonical numpy dict (``submit``, ``nodes``, ``runtime``, ``start``,
``finish``, ``ready``, ``wait``, ``makespan``, ``n_events``, ``done``,
``valid``, plus ``alloc_first``/``alloc_span``/``alloc_sum`` and the
``ev_*`` log cut to ``n_events`` when the scenario has a topology), so the
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
                with_alloc=self.scenario.topology is not None)
        return self._np

    def __getitem__(self, key: str) -> np.ndarray:
        return self.to_np()[key]

    def summary(self) -> Dict[str, float]:
        """n_jobs, wait statistics, bounded slowdown, makespan,
        utilization and throughput, plus the job-span and fragmentation
        scalars when the scenario has a topology."""
        out = self.to_np()
        s = metrics.summary(out, int(self.scenario.total_nodes))
        if "ev_time" in out and "alloc_span" in out:
            s.update(metrics.alloc_summary(out))
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
                    with_alloc: bool = False) -> Dict[str, np.ndarray]:
    """``SimResult`` + ``JobSet`` -> the canonical numpy dict."""
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
    return out
