"""The ranks' side of ``tests/test_torch_mesh.py``: functions that
``repro_torch.launch.spawn_world`` runs on every rank of a gloo world on
the CPU.  They import only the port (never JAX, so a rank starts fast),
compare each mesh result with the ``mesh=None`` result on the rank itself,
field by field with shapes and dtypes, and return the differences and, on
rank 0, the results as numpy for the test to hold against the JAX
package."""

import dataclasses
import os

import numpy as np
import torch

import repro_torch as rt
from repro_torch.api import build_jobset
from repro_torch.core import engine, parallel
from repro_torch.core.jobs import MemberScalars, make_jobset
from repro_torch.traces import das2_like

CPU = "cpu"

# the ensembles: das2 seeds under two policies, a failures list, a DAG seed
# axis whose members carry different edge counts (padded to 64 and 128)
ENS_SEEDS = (0, 1, 2, 3)
ENS_POLICIES = ("fcfs", "backfill")
ENS_JOBS, ENS_NODES = 120, 128
FAIL_MODELS = tuple(dict(mtbf=m, seed=s, max_failures=32, horizon=20_000,
                         requeue=q)
                    for m, s, q in ((80_000.0, 1, "requeue"),
                                    (120_000.0, 2, "abort"),
                                    (100_000.0, 3, "requeue"),
                                    (60_000.0, 4, "requeue")))
FAIL_POLICIES = ("fcfs", "backfill", "sjf", "backfill")
DAG = dict(kind="random", params=(("n_tasks", 32), ("n_layers", 5)))
DAG_SEEDS = (0, 1, 2, 3)
DAG_POLICIES = ("fcfs", "sjf", "backfill", "bestfit")
# the allocation sweep
ALLOC_JOBS, ALLOC_STRATEGIES = 100, ("simple", "contiguous", "spread", "topo")
# the multicluster runs: tests/test_multicluster_sharded.py's shape, whose
# rounds have one exporter at most; and "hot": three clusters' submits
# compressed 4x, whose rounds export from two clusters on different ranks
# at once (the gathered packets' order decides the landing rows)
MC_C, MC_J = 4, 120
MC_RUNS = {
    "sharded": dict(seed0=50, hot=(), nodes=96, capacity=MC_J + 32,
                    kw=dict(window=4000, migrate=True, max_export=4)),
    "hot": dict(seed0=60, hot=(0, 1, 2), nodes=64, capacity=MC_J + 64,
                kw=dict(window=2000, migrate=True, max_export=4,
                        load_imbalance_threshold=1.2)),
}


def ens_scenarios(kind: str) -> list:
    """The members of ensemble ``kind`` as port scenarios."""
    if kind == "policies":
        return [rt.Scenario(trace=rt.SyntheticTrace(n_jobs=ENS_JOBS, seed=s,
                                                    kind="das2"),
                            total_nodes=ENS_NODES, policy=p)
                for s in ENS_SEEDS for p in ENS_POLICIES]
    if kind == "failures":
        return [rt.Scenario(trace=rt.SyntheticTrace(n_jobs=ENS_JOBS, seed=7,
                                                    kind="das2"),
                            total_nodes=64, policy=p,
                            failures=rt.FailureModel(**f))
                for p, f in zip(FAIL_POLICIES, FAIL_MODELS)]
    return [rt.Scenario(trace=rt.WorkflowTrace(seed=s, **DAG), total_nodes=8,
                        policy=p) for s, p in zip(DAG_SEEDS, DAG_POLICIES)]


def mc_traces(run: str) -> list:
    spec = MC_RUNS[run]
    traces = [das2_like(MC_J, seed=spec["seed0"] + c) for c in range(MC_C)]
    for c in spec["hot"]:
        traces[c]["submit"] = traces[c]["submit"] // 4
    return traces


def mc_horizon(traces) -> int:
    return int(max(t["submit"].max() for t in traces) + 50_000)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def tree_diff(a, b, path: str = "") -> list:
    """The paths where two result trees differ: tensors and arrays by
    dtype, shape and value, lists, dataclasses and host scalars."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        if not (torch.is_tensor(a) and torch.is_tensor(b)):
            return [f"{path}: tensor against {type(b).__name__}"]
        if a.dtype != b.dtype or a.shape != b.shape:
            return [f"{path}: {a.dtype}{list(a.shape)} against "
                    f"{b.dtype}{list(b.shape)}"]
        if a.device != b.device:
            return [f"{path}: on {a.device} against {b.device}"]
        return [] if torch.equal(a, b) else [f"{path}: values"]
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return [f"{path}: {a.dtype}{a.shape} against {b.dtype}{b.shape}"]
        return [] if np.array_equal(a, b) else [f"{path}: values"]
    if isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return [f"{path}: {type(a).__name__} of {len(a)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in tree_diff(x, y, f"{path}[{i}]")]
    if isinstance(a, MemberScalars):
        return [f"{path}.{k}" for k in MemberScalars.__slots__
                if getattr(a, k) != getattr(b, k)]
    if dataclasses.is_dataclass(a):
        if type(a) is not type(b):
            return [f"{path}: {type(a).__name__} against {type(b).__name__}"]
        return [d for f in dataclasses.fields(a)
                for d in tree_diff(getattr(a, f.name), getattr(b, f.name),
                                   f"{path}.{f.name}")]
    return [] if a == b else [f"{path}: {a!r} against {b!r}"]


def summary_diff(a: dict, b: dict, path: str) -> list:
    if set(a) != set(b):
        return [f"{path}: summary keys"]
    return [f"{path}.summary[{k}]" for k in a
            if not (a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])))]


def result_diff(a, b, path: str) -> list:
    """Two ``Result``s: ``to_np()`` key by key, ``summary()``, the raw
    result and the job table field by field."""
    x, y = a.to_np(), b.to_np()
    bad = [] if set(x) == set(y) else [f"{path}: to_np keys"]
    bad += [d for k in x if k in y
            for d in tree_diff(np.asarray(x[k]), np.asarray(y[k]),
                               f"{path}.to_np[{k}]")]
    bad += summary_diff(a.summary(), b.summary(), path)
    bad += tree_diff(a.raw, b.raw, f"{path}.raw")
    bad += tree_diff(a.jobs, b.jobs, f"{path}.jobs")
    if a.scenario != b.scenario or a.backend != b.backend:
        bad.append(f"{path}: scenario or backend")
    return bad


def as_np(x, prefix: str = "") -> dict:
    """A result tree as flat ``{path: numpy}`` (the form the test holds
    against the JAX package's)."""
    if x is None:
        return {}
    if torch.is_tensor(x):
        return {prefix: x.cpu().numpy()}
    if isinstance(x, (list, np.ndarray, int, bool)):
        return {prefix: np.asarray(x)}
    if isinstance(x, MemberScalars):
        return {}
    return {k: v for f in dataclasses.fields(x)
            for k, v in as_np(getattr(x, f.name),
                              f"{prefix}.{f.name}" if prefix else f.name
                              ).items()}


# ---------------------------------------------------------------------------
# the checks of one world
# ---------------------------------------------------------------------------


def _ensemble(kind: str, mesh):
    scns = ens_scenarios(kind)
    jobs = parallel.stack_jobsets([build_jobset(s, device=CPU)
                                   for s in scns])
    kw = dict(device=CPU)
    if kind == "failures":
        kw["failures_b"] = [s.failures for s in scns]
    return parallel.simulate_ensemble(
        jobs, [s.policy for s in scns], [s.total_nodes for s in scns],
        mesh=mesh, **kw)


def _alloc_sweep(mesh):
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=ALLOC_JOBS, seed=5,
                                              kind="sdsc_sp2"),
                      total_nodes=16, topology=rt.Topology.mesh2d(4, 4))
    machine = scn.topology.build(CPU)
    return parallel.simulate_alloc_sweep(
        build_jobset(scn, device=CPU), "backfill", 16, machine,
        ALLOC_STRATEGIES, mesh=mesh, device=CPU)


def sweep_grids() -> dict:
    """The sweeps: two static buckets of 3 points (padded over 2 and 4
    ranks), a DAG seed axis of 3 points with ragged edge lists, and
    multicluster points."""
    mc = rt.Scenario(trace=tuple(rt.SyntheticTrace(n_jobs=40, seed=s,
                                                   kind="das2")
                                 for s in range(2)),
                     total_nodes=64, policy="backfill",
                     multicluster=rt.Multicluster(window=4000))
    return {
        "buckets": (rt.Scenario(trace=rt.SyntheticTrace(
            n_jobs=100, seed=3, kind="das2"), total_nodes=64),
            {"policy": ("fcfs", "sjf", "backfill"),
             "capacity": (None, 160)}),
        "dag": (rt.Scenario(trace=rt.WorkflowTrace(**DAG), total_nodes=8,
                            policy="fcfs"), {"trace.seed": (0, 1, 2)}),
        "multicluster": (mc, {"multicluster.window": (2000, 8000)}),
    }


def _multicluster(mesh, run: str = "sharded"):
    spec, traces = MC_RUNS[run], mc_traces(run)
    jc = parallel.stack_jobsets([
        make_jobset(t["submit"], t["runtime"], t["nodes"], t["estimate"],
                    capacity=spec["capacity"], total_nodes=spec["nodes"],
                    device=CPU)
        for t in traces])
    return parallel.simulate_multicluster(
        jc, "backfill", [spec["nodes"]] * MC_C, horizon=mc_horizon(traces),
        mesh=mesh, device=CPU, **spec["kw"])


def world_checks(mesh) -> dict:
    """Every mesh entry against ``mesh=None`` on this rank: ``diffs``
    (each check's differing paths), the launch and migration counts, and on
    rank 0 the numpy results."""
    import torch.distributed as dist
    rank = dist.get_rank()
    out = {"rank": rank, "R": mesh.size(0), "diffs": {}, "np": {}}

    def keep(name, res):
        if rank == 0:
            out["np"][name] = res

    for kind in ("policies", "failures", "dag"):
        got, want = _ensemble(kind, mesh), _ensemble(kind, None)
        out["diffs"][f"ensemble_{kind}"] = tree_diff(got, want)
        keep(f"ensemble_{kind}", as_np(got))
    got, want = _alloc_sweep(mesh), _alloc_sweep(None)
    out["diffs"]["alloc_sweep"] = tree_diff(got, want)
    keep("alloc_sweep", as_np(got))

    for name, (scn, axes) in sweep_grids().items():
        want = rt.sweep(scn, axes, device=CPU)
        rt.reset_cache_stats(clear=True)
        got = rt.sweep(scn, axes, mesh=mesh, device=CPU)
        first = rt.cache_stats()
        rt.reset_cache_stats()
        again = rt.sweep(scn, axes, mesh=mesh, device=CPU)
        second = rt.cache_stats()
        d = [] if got.n_compiles == want.n_compiles else ["n_compiles"]
        d += [] if got.points == want.points else ["points"]
        for i, (a, b) in enumerate(zip(got.results, want.results)):
            d += result_diff(a, b, f"[{i}]")
            d += result_diff(again.results[i], b, f"again[{i}]")
        out["diffs"][f"sweep_{name}"] = d
        out[f"sweep_{name}_cache"] = (first.compiles, first.hits,
                                      second.compiles, second.hits,
                                      got.n_compiles)
        keep(f"sweep_{name}", {"n_compiles": got.n_compiles,
                               "results": [(r.to_np(), r.summary())
                                           for r in got.results]})

    for run in MC_RUNS:
        parallel.reset_counters()
        got = _multicluster(mesh, run)
        out[f"mc_{run}_counters"] = dict(parallel.counters)
        want = _multicluster(None, run)
        out["diffs"][f"multicluster_{run}"] = tree_diff(got, want)
        keep(f"multicluster_{run}", {
            "np": parallel.multicluster_result_np(got),
            "state": as_np(got.state), "jobs": as_np(got.jobs),
            "n_events": got.state.n_events, "migrated": got.migrated})
    return out


def refusals(mesh) -> dict:
    """Over 3 ranks: an ensemble of 3 members (a multiple) runs, one of 4
    and a multicluster of 4 clusters are refused, as the reference refuses
    them; a device that contradicts the mesh is refused; the mesh
    helpers."""
    from repro_torch.launch import mesh as lmesh
    out = {}
    scns = ens_scenarios("policies")
    jobs = parallel.stack_jobsets([build_jobset(s, device=CPU)
                                   for s in scns[:3]])
    got = parallel.simulate_ensemble(jobs, ["fcfs"] * 3, [128] * 3,
                                     mesh=mesh, device=CPU)
    want = parallel.simulate_ensemble(jobs, ["fcfs"] * 3, [128] * 3,
                                      device=CPU)
    out["three_of_three"] = tree_diff(got, want)

    def refused(fn) -> str:
        try:
            fn()
        except Exception as e:
            return f"{type(e).__name__}: {e}"
        return "ran"

    four = parallel.stack_jobsets([build_jobset(s, device=CPU)
                                   for s in scns[:4]])
    out["ensemble_of_4"] = refused(lambda: parallel.simulate_ensemble(
        four, ["fcfs"] * 4, [128] * 4, mesh=mesh, device=CPU))
    out["multicluster_of_4"] = refused(lambda: _multicluster(mesh))
    out["cuda_device"] = refused(lambda: parallel.simulate_ensemble(
        jobs, ["fcfs"] * 3, [128] * 3, mesh=mesh, device="cuda"))
    out["production"] = refused(lambda: lmesh.make_production_mesh())
    out["num_devices"] = lmesh.mesh_num_devices(mesh)
    two = lmesh.make_local_mesh(("data", "model"), device_type="cpu")
    out["local_mesh"] = (tuple(two.shape), two.mesh_dim_names,
                         lmesh.mesh_num_devices(two), two.size(0),
                         two.get_local_rank(0), str(lmesh.mesh_device(two)))
    got = parallel.simulate_ensemble(jobs, ["fcfs"] * 3, [128] * 3,
                                     mesh=two, device=CPU)
    out["two_axis_mesh"] = tree_diff(got, want)
    return out


def fail_on_rank_1(mesh, where: str):
    """Rank 1 fails inside the run: ``raise`` in the ensemble's block or a
    multicluster window, or ``exit`` (the process dies in a window)."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        calls = {"n": 0}
        window = engine.simulate_window_batch
        block = engine.simulate_batch

        def broken_window(*a, **k):
            calls["n"] += 1
            if calls["n"] == 3:
                if where == "exit":
                    os._exit(3)
                raise RuntimeError("injected window failure")
            return window(*a, **k)

        def broken_block(*a, **k):
            raise RuntimeError("injected block failure")

        engine.simulate_window_batch = broken_window
        engine.simulate_batch = broken_block
    if where == "ensemble":
        return _ensemble("policies", mesh)
    return _multicluster(mesh)
