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

**Over a mesh** (``mesh=``, a ``torch.distributed`` ``DeviceMesh``:
``launch.mesh.make_local_mesh``) every entry is SPMD: each rank calls it
with the same arguments, takes the contiguous block of members or
clusters of its place on the mesh's first axis (the reference's
``P(axis)``), runs that block on its own device in lockstep
(``engine._BatchRun``), and returns the whole result, gathered in rank
order, equal field by field to the ``mesh=None`` result.  An ensemble's
ranks do not communicate until that gather; a multicluster round gathers
the clusters' loads and then the migration packets (:func:`_exchange`).
The collectives move host objects over the mesh's gloo group.  A rank
that raises before a gather makes every rank raise there; one that raises
elsewhere makes the others fail at the group's timeout.
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

def stack_jobsets(jobsets: list[JobSet],
                  edge_capacity: Optional[int] = None) -> JobSet:
    """Stack equally sized job tables into one with ``[B, J]`` columns.

    Every member must have the same capacity and lie on one device.  When
    any member carries dependency edges, every member's edge list is
    padded to the longest with pad edges (index ``capacity``, as
    ``make_jobset`` pads), a member without edges getting pad edges only,
    so the stack's ``dep_dst``/``dep_src`` are ``[B, E]``; pad edges count
    into a slot that is cut off, so no member's schedule changes.  An
    ``edge_capacity`` pads every member to that width, edges or not (a
    block of a stack whose other blocks carry edges)."""
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
    if edge_capacity is not None or any(j.dep_dst is not None
                                        for j in jobsets):
        E = max(j.edge_capacity for j in jobsets)
        if edge_capacity is not None:
            if edge_capacity < E:
                raise ValueError(f"edge_capacity {edge_capacity} is below "
                                 f"a member's {E} edges")
            E = edge_capacity
        for f in EDGE_FIELDS:
            cols[f] = torch.stack([torch.nn.functional.pad(
                torch.zeros(0, dtype=torch.int32, device=j.device)
                if getattr(j, f) is None else getattr(j, f),
                (0, E - j.edge_capacity), value=j.capacity)
                for j in jobsets])
    return JobSet(**cols)


# ---------------------------------------------------------------------------
# a device mesh's first axis
# ---------------------------------------------------------------------------

# host counters of the mesh runs: multicluster exchanges that moved jobs,
# and the migrated jobs whose source and destination clusters lie on
# different ranks (every rank counts every rank's)
counters = {"exchanges": 0, "cross_rank_migrations": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place on a mesh's first axis (the reference's ``sim``
    axis): the axis's gloo group, its size ``R``, this rank's index ``r``
    on it and its device."""

    group: object
    R: int
    r: int
    device: torch.device

    def block(self, n: int) -> slice:
        """This rank's rows of ``n`` (a multiple of ``R``), as ``P(axis)``
        lays them out: ``[r n / R, (r + 1) n / R)``."""
        k = n // self.R
        return slice(self.r * k, (self.r + 1) * k)

    def gather(self, fn) -> list:
        """``fn()`` on this rank, and every rank's value (a host object)
        in rank order.  When a rank's ``fn`` raised, every rank raises
        here: that rank its own exception, the others a ``RuntimeError``
        naming it."""
        import torch.distributed as dist
        try:
            mine, err = ("ok", fn()), None
        except Exception as e:
            mine, err = ("err", f"{type(e).__name__}: {e}"), e
        parts = [None] * self.R
        dist.all_gather_object(parts, mine, group=self.group)
        if err is not None:
            raise err
        bad = [f"rank {q} of the mesh failed: {v}"
               for q, (k, v) in enumerate(parts) if k == "err"]
        if bad:
            raise RuntimeError("; ".join(bad))
        return [v for _, v in parts]


def mesh_shard(mesh, device=None) -> Shard:
    """The :class:`Shard` of this rank on ``mesh``'s first axis; ``device``
    must agree with the mesh (``launch.mesh.mesh_device``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import mesh_device
    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a torch.distributed DeviceMesh "
                        "(repro_torch.launch.make_local_mesh), got "
                        f"{type(mesh).__name__}")
    group = mesh.get_group(0)
    backend = str(dist.get_backend(group))
    if "gloo" not in backend:
        raise ValueError(
            f"the mesh's first axis runs on {backend!r}: the simulator's "
            "collectives move host objects and need a gloo process group "
            "(init_process_group(backend='gloo'))")
    return Shard(group, mesh.size(0), mesh.get_local_rank(0),
                 mesh_device(mesh, device))


def to_host(x):
    """A result tree (dataclasses and dicts of tensors, arrays, lists) with
    every tensor on the CPU, to cross ranks."""
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: to_host(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    return x


def concat(parts: list, device):
    """The blocks of a result tree joined along their leading dim, in
    order, tensors on ``device``: the whole result of a sharded run."""
    x = parts[0]
    if x is None:
        return None
    if torch.is_tensor(x):
        return torch.cat(parts).to(device)
    if isinstance(x, np.ndarray):
        return np.concatenate(parts)
    if isinstance(x, list):
        return [v for p in parts for v in p]
    if isinstance(x, dict):
        return {k: concat([p[k] for p in parts], device) for k in x}
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: concat([getattr(p, f.name) for p in parts],
                                         device)
                          for f in dataclasses.fields(x)})
    raise TypeError(f"cannot join blocks of {type(x).__name__}")


def take_rows(jobs: JobSet, rows: slice) -> JobSet:
    """Rows ``rows`` of a stacked table, its edge width kept."""
    return jobs._map(lambda t: t[rows])


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
    lie elsewhere.

    With ``mesh`` (module doc) ``B`` must divide by the size ``R`` of the
    mesh's first axis; rank ``r`` runs members ``[r B / R, (r + 1) B /
    R)`` of the table (kept at its edge width) on its own device, which
    ``device`` may only name, and every rank returns the whole result on
    its device, equal to the ``mesh=None`` result.  The default event cap
    is a member's, whatever ``R``."""
    if jobs_b.batch is None:
        raise ValueError("simulate_ensemble needs a stacked table "
                         "(stack_jobsets)")
    shard = None if mesh is None else mesh_shard(mesh, device)
    device = resolve_device(device) if shard is None else shard.device
    B = jobs_b.batch
    if shard is not None and B % shard.R:
        raise ValueError(f"an ensemble of {B} members does not divide over "
                         f"the {shard.R} ranks of the mesh's first axis")
    if shard is None and jobs_b.device != device:
        jobs_b = jobs_b.to(device)
    pols = list(policies_b)
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
    if shard is None:
        return engine.simulate_batch(jobs_b, pols, total_nodes_b,
                                     machine=machine, alloc_b=strategies,
                                     contention_b=contentions,
                                     failures_b=fails, service_b=svcs,
                                     malleable_b=mals, max_events=max_events)
    # what simulate_batch refuses, refused for the whole ensemble on every
    # rank alike, and the whole ensemble's event cap
    J = jobs_b.capacity
    if len(pols) != B or len(total_nodes_b) != B:
        raise ValueError(f"{len(pols)} policies and {len(total_nodes_b)} "
                         f"node counts for {B} members")
    engine._check_streams(machine, fails, svcs, J)
    engine._check_malleable(mals, J,
                            any(c.enabled for c in contentions or ()),
                            [engine.policies_id(p) for p in pols])
    if max_events is None:
        max_events = engine._event_cap(J, *(None if c is None else c[0]
                                            for c in (fails, svcs, mals)))
    rows = shard.block(B)

    def cut(xs):
        return None if xs is None else xs[rows]

    block = take_rows(jobs_b, rows).to(device)
    parts = shard.gather(lambda: to_host(engine.simulate_batch(
        block, pols[rows], total_nodes_b[rows], machine=machine,
        alloc_b=cut(strategies), contention_b=cut(contentions),
        failures_b=cut(fails), service_b=cut(svcs), malleable_b=cut(mals),
        max_events=max_events)))
    return concat(parts, device)


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
    ``len(strategies)``, in the order given.  With ``mesh`` the strategies
    are sharded as ``simulate_ensemble``'s members are."""
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
              threshold: float, loads: list,
              shard: Optional[Shard] = None) -> tuple:
    """One round's migration over the lockstep run ``run``, from every
    cluster's queue load (``loads``, in cluster order): the host's float32
    imbalance test in the reference's order, the exports of the overloaded
    clusters to the least loaded one (the first on ties), and its imports.
    Rebinds ``run`` to the new table.  Returns each cluster's exported and
    dropped counts.

    With ``shard``, ``run`` holds this rank's block of clusters: every rank
    takes the same decision from the gathered ``loads``, exports from its
    own clusters, gathers every rank's packets (rank-major, then cluster,
    then slot: the single-device order) and imports those bound for its
    own clusters."""
    jobs, state = run.jobs, run.state
    Cl = jobs.batch
    lo = 0 if shard is None else shard.r * Cl
    dest, over = _imbalance(loads, threshold)
    if not any(over):
        return [0] * Cl, [0] * Cl
    mine = over[lo:lo + Cl]
    jobs, pkt = _export_jobs(jobs, state, t_hi, latency, max_export,
                             torch.tensor(mine).to(jobs.device))
    flat = {f: v.reshape(-1) for f, v in pkt.items()}
    if shard is not None:
        parts = shard.gather(lambda: to_host(flat))
        flat = concat(parts, jobs.device)
        ok = flat["ok"].cpu().reshape(shard.R, -1)   # every packet: dest
        counters["exchanges"] += 1
        counters["cross_rank_migrations"] += int(ok.sum()
                                                 - ok[dest // Cl].sum())
        if not (any(mine) or lo <= dest < lo + Cl):   # nothing moves here
            return [0] * Cl, [0] * Cl
    to_dest = torch.tensor([lo + c == dest for c in range(Cl)]).to(
        jobs.device)
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
    ``cuda`` (and raises without one).

    With ``mesh`` (module doc) ``C`` must divide by the size ``R`` of the
    mesh's first axis; rank ``r`` runs clusters ``[r C / R, (r + 1) C /
    R)`` on its own device and each round's exchange gathers the loads
    and the packets across the ranks (:func:`_exchange`); every rank
    returns the whole result, equal to the ``mesh=None`` result."""
    if jobs_c.batch is None:
        raise ValueError("simulate_multicluster needs a stacked [C, J] "
                         "table (stack_jobsets)")
    shard = None if mesh is None else mesh_shard(mesh, device)
    device = resolve_device(device) if shard is None else shard.device
    C, J = jobs_c.batch, jobs_c.capacity
    if shard is not None and C % shard.R:
        raise ValueError(f"{C} clusters do not divide over the {shard.R} "
                         "ranks of the mesh's first axis")
    latency = int(latency if latency is not None else window)
    if latency < window:
        raise ValueError("migration latency must be >= window for "
                         "conservative sync")
    nodes_c = [int(n) for n in nodes_c]
    n_rounds = math.ceil(horizon / window) + 1
    cap = max_events if max_events is not None else 2 * J + 8
    pol = engine.policies_id(policy)
    rows = slice(None) if shard is None else shard.block(C)
    jobs = jobs_c if shard is None else take_rows(jobs_c, rows)
    if jobs.device != device:
        jobs = jobs.to(device)
    Cl = jobs.batch
    run = engine._BatchRun(jobs, [pol] * Cl, nodes_c[rows], cap)
    mig, drop, sat = [0] * Cl, [0] * Cl, [False] * Cl

    def window_round(t_hi: int):
        """The round's window and, with migration, the clusters' loads
        (one read)."""
        sat_r = engine.simulate_window_batch(run, t_hi, cap)
        return sat_r, (_queue_load(run.jobs, run.state).tolist()
                       if migrate else None)

    for r in range(n_rounds):
        t_hi = _i32((r + 1) * int(window))
        if shard is not None and migrate:
            # the round's agreement: a rank that failed its window fails
            # every rank here
            parts = shard.gather(lambda: window_round(t_hi))
            sat_r = parts[shard.r][0]
            loads = [x for _, block in parts for x in block]
        else:
            sat_r, loads = window_round(t_hi)
        sat = [a or b for a, b in zip(sat, sat_r)]
        if migrate:
            sent, lost = _exchange(run, t_hi, latency, max_export,
                                   load_imbalance_threshold, loads, shard)
            mig = [a + b for a, b in zip(mig, sent)]
            drop = [a + b for a, b in zip(drop, lost)]

    def drain() -> MulticlusterResult:
        sat_d = engine.simulate_window_batch(run, INF_TIME, cap)
        return MulticlusterResult(
            jobs=run.jobs, state=run.state,
            migrated=np.array(mig, dtype=np.int32),
            dropped=np.array(drop, dtype=np.int32),
            saturated=np.array([a or b for a, b in zip(sat, sat_d)]))

    if shard is None:
        return drain()
    return concat(shard.gather(lambda: to_host(drain())), device)


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
