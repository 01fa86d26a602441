"""Ensembles of the PyTorch port (paper Fig. 5, DESIGN.md §2 and §12.2).

Counterpart of ``repro.core.parallel``'s ensemble mode: many independent
simulations (policy sweeps, machine sizes, trace seeds, placement
strategies, contention models, failure streams, service plans and
malleable plans) advanced together.  The reference ``vmap``s its device
``while_loop``; here the members are the rows of a stacked ``[B, J]`` job
table, and ``core.engine.simulate_batch`` drives them in lockstep from the
host: one event step for every member, and one launch of the batched
``queue_select`` kernel for every round of selections (or walks) of the
members still in their scheduling pass.  A member that is done is frozen,
so each member equals its own solo run bit for bit.

Members may carry dependency edges of different counts (a seed axis over
a DAG): ``stack_jobsets`` pads them to one length.

Not ported yet: sharding an ensemble over several cards (``mesh``: ROADMAP
Queue 1 item 12), and multicluster windows (item 6).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import alloc as _alloc
from repro_torch.core import engine
from repro_torch.core.jobs import (
    EDGE_FIELDS, JOB_COLUMNS, JobSet, SimResult, resolve_device,
)
from repro_torch.malleable.model import make_mal_ctx
from repro_torch.reliability.model import make_fail_ctx
from repro_torch.serving.model import make_svc_ctx

_NOT_PORTED = {
    "mesh": "ROADMAP Queue 1 item 12 (ensembles over several cards)",
}


def stack_jobsets(jobsets: list[JobSet]) -> JobSet:
    """Stack equally sized job tables into one with ``[B, J]`` columns.

    Every member must have the same capacity and lie on one device.  When
    any member carries dependency edges, every member's edge list is
    padded to the longest with pad edges (index ``capacity``, as
    ``make_jobset`` pads), a member without edges getting pad edges only,
    so the stack's ``dep_dst``/``dep_src`` are ``[B, E]``; pad edges sit
    past every row's CSR range, so no member's schedule changes."""
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
    cols = {f: torch.stack([getattr(j, f) for j in jobsets])
            for f in JOB_COLUMNS}
    if any(j.dep_dst is not None for j in jobsets):
        E = max(j.edge_capacity for j in jobsets)
        for f in EDGE_FIELDS:
            cols[f] = torch.stack([torch.nn.functional.pad(
                torch.zeros(0, dtype=torch.int32, device=j.device)
                if getattr(j, f) is None else getattr(j, f),
                (0, E - j.edge_capacity), value=j.capacity)
                for j in jobsets])
    return JobSet(**cols)


def simulate_ensemble(jobs_b: JobSet, policies_b, total_nodes_b, *,
                      machine=None, alloc_b=None, contention=None,
                      failures_b=None, service_b=None, malleable_b=None,
                      mesh=None, max_events: Optional[int] = None,
                      device=None) -> SimResult:
    """Run the members of a stacked table together, each with its own
    policy (a name or id) and its own node count.

    With ``machine`` (one machine for every member, whose node count every
    ``total_nodes_b`` entry must equal) ``alloc_b`` gives each member's
    placement strategy (names or ids; default ``simple``) and
    ``contention`` the dilation: one spec (``None``, ``(num, den)`` or a
    ``Contention``) for every member, or a list of one spec a member.
    ``failures_b`` (what ``simulate``'s ``failures`` takes) and
    ``service_b`` (what its ``service`` takes) are likewise one spec for
    every member or a list of one a member; each member consumes its own
    streams.  ``malleable_b`` (what ``simulate``'s ``malleable`` takes,
    one plan for every member or a list of one a member) gives each member
    its malleable jobs; it refuses contention and preempt, as ``simulate``
    does.

    Returns a ``SimResult`` with ``[B, ...]`` fields and per-member
    ``makespan`` and ``n_events`` lists; ``SimResult.member(b)`` equals
    ``engine.simulate`` of member ``b`` alone.  ``max_events`` caps every
    member's event count (default ``6 * capacity + 8``, as in the
    reference, plus the streams' share).  ``device=None`` runs on ``cuda``
    (and raises without one); the table and the machine move there if they
    lie elsewhere.  The reference's mesh argument raises
    ``NotImplementedError`` naming the ROADMAP item that brings it."""
    given = {"mesh": mesh}
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
    B = jobs_b.batch
    total_nodes_b = [int(t) for t in total_nodes_b]
    strategies = contentions = None
    if machine is None:
        if alloc_b is not None or contention is not None:
            raise ValueError(
                "alloc_b/contention require machine=; without a Machine the "
                "ensemble runs in scalar-counter mode and would silently "
                "ignore them")
    else:
        bad = sorted({t for t in total_nodes_b if t != machine.n_nodes})
        if bad:
            raise ValueError(f"machine has {machine.n_nodes} nodes but "
                             f"total_nodes_b contains {bad}")
        if machine.device != device:
            machine = machine.to(device)
        strategies = (_alloc.canonical_id(list(alloc_b)) if alloc_b is not None
                      else [_alloc.SIMPLE] * B)
        cons = contention if isinstance(contention, list) else [contention] * B
        contentions = [_alloc.Contention.canonical(c) for c in cons]
        if len(strategies) != B or len(contentions) != B:
            raise ValueError(f"{len(strategies)} strategies and "
                             f"{len(contentions)} contention models for {B} "
                             "members")
    fails = _per_member(failures_b, B, make_fail_ctx, total_nodes_b)
    svcs = _per_member(service_b, B, make_svc_ctx, total_nodes_b)
    mals = _per_member(malleable_b, B,
                       lambda s, n_nodes: make_mal_ctx(s), total_nodes_b)
    return engine.simulate_batch(jobs_b, list(policies_b), total_nodes_b,
                                 machine=machine, alloc_b=strategies,
                                 contention_b=contentions, failures_b=fails,
                                 service_b=svcs, malleable_b=mals,
                                 max_events=max_events)


def _per_member(spec, B: int, make, total_nodes_b) -> Optional[list]:
    """One context a member (``make(spec, n_nodes=...)``) from one spec for
    all or a list of one a member; ``None`` stays ``None``."""
    if spec is None:
        return None
    specs = spec if isinstance(spec, list) else [spec] * B
    if len(specs) != B:
        raise ValueError(f"{len(specs)} stream specs for {B} members")
    return [make(s, n_nodes=n) for s, n in zip(specs, total_nodes_b)]


def simulate_alloc_sweep(jobs: JobSet, policy, total_nodes: int, machine,
                         strategies=("simple", "contiguous", "spread",
                                     "topo"), *,
                         contention=None, mesh=None,
                         max_events: Optional[int] = None,
                         device=None) -> SimResult:
    """Run ONE trace under every allocation strategy as one ensemble.

    ``sweep(scenario, axes={"alloc": strategies})`` is the general form and
    gives the same members.  Returns a ``SimResult`` with a leading dim of
    ``len(strategies)``, in the order given."""
    B = len(strategies)
    return simulate_ensemble(
        stack_jobsets([jobs] * B), [int(engine.policies_id(policy))] * B,
        [int(total_nodes)] * B, machine=machine,
        alloc_b=_alloc.canonical_id(list(strategies)),
        contention=contention, mesh=mesh, max_events=max_events,
        device=device)
