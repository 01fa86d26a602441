"""Ensembles of the PyTorch port (paper Fig. 5, DESIGN.md §2 and §12.2).

Counterpart of ``repro.core.parallel``'s ensemble mode in scalar-counter
mode: many independent simulations (policy sweeps, machine sizes, trace
seeds) advanced together.  The reference ``vmap``s its device
``while_loop``; here the members are the rows of a stacked ``[B, J]`` job
table, and ``core.engine.simulate_batch`` drives them in lockstep from the
host: one event step for every member, and one launch of the batched
``queue_select`` kernel for every round of selections (or walks) of the
members still in their scheduling pass.  A member that is done is frozen,
so each member equals its own solo run bit for bit.

Not ported yet: allocation (``machine``, ``alloc_b``, ``contention``:
ROADMAP Queue 1 item 2), failures (``failures_b``: item 5), sharding an
ensemble over several cards (``mesh``: item 12), and multicluster windows
(item 6).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core.jobs import (
    JOB_FIELDS, JobSet, SimResult, resolve_device,
)

_ITEM2 = "ROADMAP Queue 1 item 2 (topology-aware allocation)"
_NOT_PORTED = {
    "machine": _ITEM2,
    "alloc_b": _ITEM2,
    "contention": _ITEM2,
    "failures_b": "ROADMAP Queue 1 item 5 (extra event sources)",
    "mesh": "ROADMAP Queue 1 item 12 (ensembles over several cards)",
}


def stack_jobsets(jobsets: list[JobSet]) -> JobSet:
    """Stack equally sized job tables into one with ``[B, J]`` columns.

    Every member must have the same capacity and lie on one device.  The
    reference pads the members' dependency edge lists to one length; the
    port's tables carry none (``make_jobset`` raises on edges, ROADMAP
    Queue 1 item 3), so there is nothing to pad."""
    jobsets = list(jobsets)
    if not jobsets:
        raise ValueError("stack_jobsets needs at least one job table")
    if any(j.batch is not None for j in jobsets):
        raise ValueError("stack_jobsets takes solo tables, not stacks")
    caps = {j.capacity for j in jobsets}
    if len(caps) != 1:
        raise ValueError(f"stack_jobsets needs one capacity, got "
                         f"{sorted(caps)}")
    devices = {j.device for j in jobsets}
    if len(devices) != 1:
        raise ValueError(f"stack_jobsets needs one device, got {devices}")
    return JobSet(**{f: torch.stack([getattr(j, f) for j in jobsets])
                     for f in JOB_FIELDS})


def simulate_ensemble(jobs_b: JobSet, policies_b, total_nodes_b, *,
                      machine=None, alloc_b=None, contention=None,
                      failures_b=None, mesh=None,
                      max_events: Optional[int] = None,
                      device=None) -> SimResult:
    """Run the members of a stacked table together, each with its own
    policy (a name or id) and its own node count.

    Returns a ``SimResult`` with ``[B, J]`` fields and per-member
    ``makespan`` and ``n_events`` lists; ``SimResult.member(b)`` equals
    ``engine.simulate`` of member ``b`` alone.  ``max_events`` caps every
    member's event count (default ``6 * capacity + 8``, as in the
    reference).  ``device=None`` runs on ``cuda`` (and raises without one);
    the table moves there if it lies elsewhere.  The reference's allocation,
    failure and mesh arguments raise ``NotImplementedError`` naming the
    ROADMAP item that brings them."""
    given = {"machine": machine, "alloc_b": alloc_b,
             "contention": contention, "failures_b": failures_b,
             "mesh": mesh}
    for name, item in _NOT_PORTED.items():
        if given[name] is not None:
            raise NotImplementedError(
                f"simulate_ensemble({name}=...) is not ported yet: {item}")
    if jobs_b.batch is None:
        raise ValueError("simulate_ensemble needs a stacked table "
                         "(stack_jobsets)")
    device = resolve_device(device)
    if jobs_b.device != device:
        jobs_b = jobs_b.to(device)
    return engine.simulate_batch(jobs_b, list(policies_b),
                                 [int(t) for t in total_nodes_b],
                                 max_events=max_events)
