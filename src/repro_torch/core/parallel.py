"""Parallel discrete-event simulation of the PyTorch port (paper Figs. 5-6,
DESIGN.md §2 and §12.2).

Counterpart of ``repro.core.parallel``, in its two modes.

**Ensembles**: many independent
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

**Multicluster conservative windows** (:func:`simulate_multicluster`): one
simulation partitioned into C clusters, the rows of one stacked ``[C, J]``
table, each advanced over a window ``W`` (``engine.simulate_window_batch``,
the clusters in lockstep) and then synchronized.  A migration emitted in
window ``k`` arrives with a latency ``>= W``, so it cannot affect window
``k``: the window is a valid conservative lookahead bound, SST's
synchronization contract.  The reference gathers the loads and the
packets with ``all_gather`` over a device mesh; on one card the exchange
is one host step a round, as the reference's ``mesh=None`` path, where the
gather is the identity.

Not ported yet: sharding over several cards (``mesh``: ROADMAP Queue 1
item 12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import alloc as _alloc
from repro_torch.core import engine
from repro_torch.core.jobs import (
    DONE, EDGE_FIELDS, INF_TIME, JOB_COLUMNS, PENDING, WAITING,
    EnsembleState, JobSet, SimResult, resolve_device,
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
    so the stack's ``dep_dst``/``dep_src`` are ``[B, E]``; pad edges count
    into a slot that is cut off, so no member's schedule changes."""
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


# ---------------------------------------------------------------------------
# multicluster conservative-window mode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MulticlusterResult:
    """Final per-cluster tables: ``[C, J]`` columns."""

    jobs: JobSet            # post-migration tables (valid marks ownership)
    state: EnsembleState
    migrated: np.ndarray    # i32[C] jobs exported by each cluster
    dropped: np.ndarray     # i32[C] imports dropped for lack of free rows
    saturated: np.ndarray   # bool[C] a window hit the event cap, events due


def _i32(x: int) -> int:
    """``x`` wrapped to int32, as the reference's int32 arithmetic wraps."""
    return (int(x) + 2**31) % 2**32 - 2**31


def _queue_load(jobs: JobSet, state) -> torch.Tensor:
    """Pending work of each table: the node-seconds waiting in its queue
    (estimates capped at 2^16), an int32 sum that wraps as the
    reference's (``[...]`` on the device)."""
    waiting = (state.jstate == WAITING) | (state.jstate == PENDING)
    work = jobs.nodes * torch.clamp(jobs.estimate, max=1 << 16)
    return torch.sum(torch.where(waiting, work, 0), dim=-1).to(torch.int32)


def _touched(jobs: JobSet, rows: torch.Tensor) -> torch.Tensor:
    """``bool[..., J + 1]``: the rows in ``rows`` (``[..., K]``, the pad
    index ``J`` allowed), the last slot standing for the pad."""
    J = jobs.capacity
    hit = torch.zeros((*rows.shape[:-1], J + 1), dtype=torch.bool,
                      device=rows.device)
    return hit.scatter_(-1, rows.long(), True)


def _export_jobs(jobs: JobSet, state, t_hi: int, latency: int,
                 max_export: int, enable: torch.Tensor) -> tuple:
    """Pick up to ``max_export`` *tail* waiting or pending jobs of each
    cluster whose ``enable`` is set, to offload (the clusters of a
    ``[C, J]`` table at once, as the reference's vmapped call).

    Tail = largest submit first (a stable sort of the negated submits), so
    migration never reorders the local head of the queue.  A row touched
    by a live edge (either endpoint) is pinned to its cluster.  The picked
    rows leave the table (``valid`` cleared, DONE); their packet carries
    their columns and a submit of at least ``t_hi + latency``.  Returns
    ``(jobs', packet)``; the state is written in place."""
    J, K = jobs.capacity, min(int(max_export), jobs.capacity)
    movable = (((state.jstate == WAITING) | (state.jstate == PENDING))
               & jobs.valid)
    if jobs.dep_dst is not None:
        pinned = (_touched(jobs, jobs.dep_dst)
                  | _touched(jobs, jobs.dep_src))[..., :J]
        movable &= ~pinned
    key = torch.where(movable, -jobs.submit, INF_TIME)
    rows = torch.sort(key, dim=-1, stable=True)[1][..., :K]
    k = torch.arange(K, device=rows.device)
    ok = ((k < torch.where(enable, K, 0)[..., None])
          & (k < torch.sum(movable, dim=-1)[..., None]))
    arrive = torch.tensor(_i32(int(t_hi) + int(latency)),
                          dtype=torch.int32, device=rows.device)
    col = {f: torch.gather(getattr(jobs, f), -1, rows)
           for f in ("submit", "runtime", "estimate", "nodes", "priority")}
    packet = dict(col, ok=ok,
                  submit=torch.where(ok, torch.maximum(col["submit"], arrive),
                                     INF_TIME).to(torch.int32))
    remove = torch.zeros_like(movable).scatter_(-1, rows, ok)
    state.jstate.copy_(torch.where(remove, DONE, state.jstate))
    return dataclasses.replace(jobs, valid=jobs.valid & ~remove), packet


def _import_jobs(jobs: JobSet, state, flat: dict) -> tuple:
    """Insert the gathered packets meant for each cluster (``flat``:
    ``[..., P]`` columns, ``ok`` set on the packets bound for that
    cluster) into its free rows, in row order; a packet that finds no
    free row is dropped.  The landing rows' edges are neutralized (both
    endpoints to the pad index ``J``), their dependency counters cleared,
    and their ``start``, ``finish``, ``rsv_finish`` and ``remaining``
    reset.  Returns ``(jobs', dropped)``; the state is written in place.
    """
    J = jobs.capacity
    ok = flat["ok"]
    n_imp = torch.sum(ok, dim=-1)
    free_order = torch.sort(jobs.valid.to(torch.int32), dim=-1,
                            stable=True)[1]
    n_free = torch.sum(~jobs.valid, dim=-1)
    slot = torch.cumsum(ok.to(torch.int32), dim=-1) - 1
    can = ok & (slot < n_free[..., None])
    rows = torch.gather(free_order, -1, slot.clamp(0, J - 1).long())
    rows = torch.where(can, rows, J)

    def land(col: torch.Tensor, values) -> torch.Tensor:
        ext = torch.nn.functional.pad(col, (0, 1))
        if not torch.is_tensor(values):
            values = torch.full(rows.shape, values, dtype=col.dtype,
                                device=col.device)
        return ext.scatter_(-1, rows, values.to(col.dtype))[..., :J
                                                            ].contiguous()

    cols = {f: land(getattr(jobs, f), flat[f].expand(rows.shape))
            for f in ("submit", "runtime", "estimate", "nodes", "priority")}
    cols["valid"] = land(jobs.valid, True)
    cols["dep_dst"] = cols["dep_src"] = None
    if jobs.dep_dst is not None:
        landing = _touched(jobs, rows)
        hit = (torch.gather(landing, -1, jobs.dep_dst.long())
               | torch.gather(landing, -1, jobs.dep_src.long()))
        cols["dep_dst"] = torch.where(hit, J, jobs.dep_dst).to(torch.int32)
        cols["dep_src"] = torch.where(hit, J, jobs.dep_src).to(torch.int32)
        state.n_unmet.copy_(land(state.n_unmet, 0))
    state.jstate.copy_(land(state.jstate, PENDING))
    for f in ("start", "finish", "rsv_finish"):
        getattr(state, f).copy_(land(getattr(state, f), INF_TIME))
    state.remaining.copy_(land(state.remaining,
                               flat["runtime"].expand(rows.shape)))
    dropped = n_imp - torch.minimum(n_imp, n_free)
    return JobSet(**cols), dropped


def _imbalance(loads: list, threshold: float) -> tuple:
    """``(dest, over)`` of the clusters' int32 ``loads``: the least loaded
    cluster (the first on ties), and whether each cluster exports, its
    load above ``threshold`` times the mean (float32, summed in cluster
    order as the reference's mean), above the destination's, and not the
    destination itself."""
    total = np.float32(0)
    for x in loads:
        total = np.float32(total + np.float32(x))
    bar = np.float32(threshold) * np.float32(total / np.float32(len(loads)))
    least = min(loads)
    dest = loads.index(least)
    return dest, [bool(np.float32(x) > bar) and g != dest and least < x
                  for g, x in enumerate(loads)]


def _exchange(run, t_hi: int, latency: int, max_export: int,
              threshold: float) -> tuple:
    """One round's migration over the lockstep run ``run``: the clusters'
    queue loads (one read), the host's float32 imbalance test in the
    reference's order, the exports of the overloaded clusters to the least
    loaded one (the first on ties), and its imports.  Rebinds ``run`` to
    the new table.  Returns each cluster's exported and dropped counts."""
    jobs, state = run.jobs, run.state
    C = jobs.batch
    dest, over = _imbalance(_queue_load(jobs, state).tolist(), threshold)
    if not any(over):
        return [0] * C, [0] * C
    enable = torch.tensor(over).to(jobs.device)
    jobs, pkt = _export_jobs(jobs, state, t_hi, latency, max_export, enable)
    flat = {f: v.reshape(-1) for f, v in pkt.items()}
    to_dest = torch.zeros(C, dtype=torch.bool, device=jobs.device)
    to_dest[dest] = True
    flat["ok"] = flat["ok"][None, :] & to_dest[:, None]
    jobs, dropped = _import_jobs(jobs, state, flat)
    sent, dropped = torch.stack([torch.sum(pkt["ok"], dim=-1),
                                 dropped.to(torch.int64)]).tolist()
    run.bind(jobs)
    return sent, dropped


def simulate_multicluster(jobs_c: JobSet, policy, nodes_c, *, window: int,
                          horizon: int, mesh=None, migrate: bool = True,
                          max_export: int = 8,
                          latency: Optional[int] = None,
                          load_imbalance_threshold: float = 1.5,
                          max_events: Optional[int] = None,
                          device=None) -> MulticlusterResult:
    """Conservative-window multi-cluster simulation.

    ``jobs_c`` is a stacked ``[C, J]`` table (``stack_jobsets``), one
    cluster a row, and ``nodes_c`` each cluster's node count.  Round ``r``
    processes every cluster's events in ``(r W, (r + 1) W]``, the clusters
    in lockstep (``engine.simulate_window_batch``: one batched
    ``queue_select`` launch serves every cluster that selects); then a
    cluster whose queue load exceeds ``load_imbalance_threshold`` times the
    mean exports up to ``max_export`` tail jobs to the least loaded
    cluster, arriving ``latency`` (>= ``window``) after the round.  There
    are ``ceil(horizon / window) + 1`` rounds and then a drain at
    ``INF_TIME`` with no migration.  The event cap (default ``2 J + 8``)
    is each cluster's total over the run.  ``device=None`` runs on
    ``cuda`` (and raises without one).  ``mesh`` (sharding the clusters
    over several cards) raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(
            "simulate_multicluster(mesh=...) is not ported yet: ROADMAP "
            "Queue 1 item 12 (multicluster over several cards)")
    if jobs_c.batch is None:
        raise ValueError("simulate_multicluster needs a stacked [C, J] "
                         "table (stack_jobsets)")
    device = resolve_device(device)
    if jobs_c.device != device:
        jobs_c = jobs_c.to(device)
    C, J = jobs_c.batch, jobs_c.capacity
    latency = int(latency if latency is not None else window)
    if latency < window:
        raise ValueError("migration latency must be >= window for "
                         "conservative sync")
    nodes_c = [int(n) for n in nodes_c]
    n_rounds = math.ceil(horizon / window) + 1
    cap = max_events if max_events is not None else 2 * J + 8
    pol = engine.policies_id(policy)
    run = engine._BatchRun(jobs_c, [pol] * C, nodes_c, cap)
    mig, drop, sat = [0] * C, [0] * C, [False] * C
    for r in range(n_rounds):
        t_hi = _i32((r + 1) * int(window))
        sat_r = engine.simulate_window_batch(run, t_hi, cap)
        sat = [a or b for a, b in zip(sat, sat_r)]
        if migrate:
            sent, lost = _exchange(run, t_hi, latency, max_export,
                                   load_imbalance_threshold)
            mig = [a + b for a, b in zip(mig, sent)]
            drop = [a + b for a, b in zip(drop, lost)]
    sat_d = engine.simulate_window_batch(run, INF_TIME, cap)
    return MulticlusterResult(
        jobs=run.jobs, state=run.state,
        migrated=np.array(mig, dtype=np.int32),
        dropped=np.array(drop, dtype=np.int32),
        saturated=np.array([a or b for a, b in zip(sat, sat_d)]))


def multicluster_result_np(res: MulticlusterResult) -> dict:
    """The per-cluster tables flattened to one host result dict."""
    jobs, state = res.jobs, res.state

    def flat(a):
        return a.cpu().numpy().reshape(-1)

    valid = flat(jobs.valid)
    done = flat(state.jstate) == DONE
    out = {
        "submit": flat(jobs.submit),
        "runtime": flat(jobs.runtime),
        "nodes": flat(jobs.nodes),
        "start": flat(state.start),
        "finish": flat(state.finish),
        "valid": valid,
        "done": done & valid,
        "migrated": int(res.migrated.sum()),
        "dropped": int(res.dropped.sum()),
        "saturated": bool(res.saturated.any()),
    }
    if jobs.dep_dst is not None:
        dst = jobs.dep_dst.cpu().numpy()
        src = jobs.dep_src.cpu().numpy()
        fin = state.finish.cpu().numpy()
        C, J = fin.shape
        dep_fin = np.zeros((C, J), dtype=fin.dtype)
        for c in range(C):
            live = dst[c] < J
            np.maximum.at(dep_fin[c], dst[c][live], fin[c][src[c][live]])
        out["ready"] = np.maximum(jobs.submit.cpu().numpy(),
                                  dep_fin).reshape(-1)
    else:
        out["ready"] = out["submit"]
    out["wait"] = out["start"] - out["ready"]
    fin = out["finish"][out["done"]]
    out["makespan"] = int(fin.max(initial=0))
    return out
