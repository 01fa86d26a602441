"""The port's simulator over a device mesh, on the CPU with gloo ranks.

Each world is ``repro_torch.launch.spawn_world`` over 2, 3 or 4 fresh
processes on a free localhost port, bounded by ``WORLD_LIMIT`` seconds
(the world is killed past it, so no test hangs).  On every rank
(``tests/_torch_mesh_worker.py``):

- ``simulate_ensemble(mesh=)``: das2 seeds under two policies, a
  failures list, and a DAG seed axis with unequal edge counts;
- ``simulate_alloc_sweep(mesh=)`` on ``mesh2d(4, 4)`` over the four
  strategies;
- ``sweep(mesh=)``: two static buckets of 3 points (the pad path), a DAG
  seed axis of 3 points (the blocks' edge widths gathered) and
  multicluster points; a repeated call counts as hits;
- ``simulate_multicluster(mesh=)`` at ``tests/test_multicluster_sharded
  .py``'s shape, and a run whose rounds export from clusters on two
  ranks at once (the gathered packets' order decides the landing rows),
  both with migrations that cross ranks;

each equals the ``mesh=None`` result field by field, shapes, dtypes and
devices included, on every rank; here rank 0's results equal the JAX
package's (``mesh=None``) on the same inputs.  Over 3 ranks an ensemble of
4 and a multicluster of 4 clusters are refused with ``ValueError``, as
the reference refuses them, and the mesh helpers work.  A rank that
raises (or dies) makes every rank fail within the limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_worker as w
from _torch_streams import diff, jax_spec, same_summary
from repro import api
from repro.api.run import build_jobset as jax_build_jobset
from repro.core import parallel as jpar
from repro.core.jobs import POLICY_IDS
from repro.core.jobs import make_jobset as jax_make_jobset
from repro.reliability import make_fail_ctx
from repro_torch.launch import WorldError, spawn_world

WORLD_LIMIT = 300.0     # seconds a world may take, spawning included
GROUP_TIMEOUT = 60.0    # the gloo group's collective timeout


def _world(fn, R: int, *args, group_timeout: float = GROUP_TIMEOUT):
    return spawn_world(fn, R, args=args, device_type="cpu",
                       timeout=WORLD_LIMIT, group_timeout=group_timeout)


@pytest.fixture(scope="module", params=(2, 4), ids=("R2", "R4"))
def world(request):
    return _world(w.world_checks, request.param)


@pytest.fixture(scope="module")
def three():
    return _world(w.refusals, 3)


def _jax_np(x, prefix: str = "") -> dict:
    """A JAX result tree as flat ``{path: numpy}``, as ``w.as_np``."""
    if x is None:
        return {}
    if dataclasses.is_dataclass(x):
        return {k: v for f in dataclasses.fields(x)
                for k, v in _jax_np(getattr(x, f.name),
                                    f"{prefix}.{f.name}" if prefix
                                    else f.name).items()}
    return {prefix: np.asarray(x)}


def _same(port: dict, ref: dict) -> list:
    """The keys of two flat result dicts that differ (values and shapes;
    the port's host lists compare as int arrays)."""
    bad = [] if set(port) == set(ref) else [
        f"keys {sorted(set(port) ^ set(ref))}"]
    for k in set(port) & set(ref):
        a, b = port[k], ref[k]
        if a.shape != b.shape or not np.array_equal(a, b):
            bad.append(k)
    return bad


# ---------------------------------------------------------------------------
# the JAX package's results on the same inputs
# ---------------------------------------------------------------------------


def _jax_scenario(scn):
    if scn.multicluster is None:
        return jax_spec(scn)
    return api.Scenario(trace=tuple(jax_spec(t) for t in scn.trace),
                        total_nodes=scn.total_nodes, policy=scn.policy,
                        multicluster=api.Multicluster(
                            **dataclasses.asdict(scn.multicluster)))


def _jax_ensemble(kind: str):
    scns = [jax_spec(s) for s in w.ens_scenarios(kind)]
    jobs = jpar.stack_jobsets([jax_build_jobset(s) for s in scns])
    pols = np.array([POLICY_IDS[s.policy] for s in scns], np.int32)
    nodes = np.array([s.total_nodes for s in scns], np.int32)
    kw = {}
    if kind == "failures":
        kw["failures_b"] = jax.tree.map(
            lambda *xs: jnp.stack(xs),
            *[make_fail_ctx(s.failures, n_nodes=s.total_nodes)
              for s in scns])
    return jpar.simulate_ensemble(jobs, pols, nodes, **kw)


def _jax_alloc_sweep():
    scn = api.Scenario(trace=api.SyntheticTrace(n_jobs=w.ALLOC_JOBS, seed=5,
                                                kind="sdsc_sp2"),
                       total_nodes=16, topology=api.Topology.mesh2d(4, 4))
    return jpar.simulate_alloc_sweep(
        jax_build_jobset(scn), POLICY_IDS["backfill"], 16,
        scn.topology.build(), w.ALLOC_STRATEGIES)


def _jax_multicluster(run: str):
    spec, traces = w.MC_RUNS[run], w.mc_traces(run)
    jc = jpar.stack_jobsets([
        jax_make_jobset(t["submit"], t["runtime"], t["nodes"], t["estimate"],
                        capacity=spec["capacity"], total_nodes=spec["nodes"])
        for t in traces])
    return jpar.simulate_multicluster(
        jc, POLICY_IDS["backfill"], [spec["nodes"]] * w.MC_C,
        horizon=w.mc_horizon(traces), **spec["kw"])


# ---------------------------------------------------------------------------
# worlds of 2 and 4 ranks
# ---------------------------------------------------------------------------


def test_every_rank_returns_the_whole_mesh_free_result(world):
    R = len(world)
    assert [o["rank"] for o in world] == list(range(R))
    assert all(o["R"] == R for o in world)
    for o in world:
        assert {k: v for k, v in o["diffs"].items() if v} == {}, o["rank"]


@pytest.mark.parametrize("kind", ("policies", "failures", "dag"))
def test_ensemble_matches_jax(world, kind):
    got = world[0]["np"][f"ensemble_{kind}"]
    assert _same(got, _jax_np(_jax_ensemble(kind))) == []
    if kind == "dag":   # the members' edge lists are of different lengths
        assert len({jax_build_jobset(jax_spec(s)).dep_dst.shape[0]
                    for s in w.ens_scenarios("dag")}) > 1


def test_alloc_sweep_matches_jax(world):
    got = world[0]["np"]["alloc_sweep"]
    assert _same(got, _jax_np(_jax_alloc_sweep())) == []
    assert got["alloc_sum"].shape[0] == len(w.ALLOC_STRATEGIES)


@pytest.mark.parametrize("grid", ("buckets", "dag", "multicluster"))
def test_sweep_matches_jax(world, grid):
    scn, axes = w.sweep_grids()[grid]
    ref = api.sweep(_jax_scenario(scn), axes)
    got = world[0]["np"][f"sweep_{grid}"]
    assert got["n_compiles"] == ref.n_compiles
    assert len(got["results"]) == len(ref.results)
    for i, ((out, summ), r) in enumerate(zip(got["results"], ref.results)):
        assert diff(out, r.to_np()) == [], (grid, i)
        assert same_summary(summ, r.summary()), (grid, i)


@pytest.mark.parametrize("grid", ("buckets", "dag"))
def test_repeated_mesh_sweep_counts_hits(world, grid):
    """Each bucket's first mesh execution is a compile, a repeat a hit, on
    every rank alike; the mesh's size is part of the signature, so the
    mesh-free sweep run before it left no hit behind."""
    for o in world:
        first_c, first_h, again_c, again_h, n = o[f"sweep_{grid}_cache"]
        assert (first_c, first_h, again_c, again_h) == (n, 0, 0, n)


@pytest.mark.parametrize("run", tuple(w.MC_RUNS))
def test_multicluster_matches_jax_and_crosses_ranks(world, run):
    got = world[0]["np"][f"multicluster_{run}"]
    ref = _jax_multicluster(run)
    want = jpar.multicluster_result_np(ref)
    assert set(got["np"]) == set(want)
    assert [k for k in want if not np.array_equal(
        np.asarray(got["np"][k]), np.asarray(want[k]))] == []
    state = _jax_np(ref.state)
    for f in ("jstate", "start", "finish", "rsv_finish", "remaining"):
        np.testing.assert_array_equal(got["state"][f], state[f], err_msg=f)
    jobs = _jax_np(ref.jobs)
    for f in ("submit", "runtime", "estimate", "nodes", "priority", "valid"):
        np.testing.assert_array_equal(got["jobs"][f], jobs[f], err_msg=f)
    assert got["n_events"] == np.asarray(ref.state.n_events).tolist()
    assert got["migrated"].tolist() == np.asarray(ref.migrated).tolist()
    assert got["np"]["dropped"] == 0 and not got["np"]["saturated"]
    assert got["np"]["done"].sum() == w.MC_C * w.MC_J
    counts = [o[f"mc_{run}_counters"] for o in world]
    assert all(c == counts[0] for c in counts)
    assert counts[0]["exchanges"] > 0
    assert 0 < counts[0]["cross_rank_migrations"] <= got["np"]["migrated"]


# ---------------------------------------------------------------------------
# a world of 3 ranks: refusals and the mesh helpers
# ---------------------------------------------------------------------------


def test_indivisible_ensemble_and_clusters_are_refused(three):
    for o in three:
        assert o["three_of_three"] == []
        assert o["ensemble_of_4"].startswith("ValueError: an ensemble of 4 "
                                             "members does not divide")
        assert o["multicluster_of_4"].startswith(
            "ValueError: 4 clusters do not divide over the 3 ranks")
        assert o["cuda_device"].startswith("ValueError: device cuda")


def test_mesh_helpers(three):
    for r, o in enumerate(three):
        assert o["num_devices"] == 3
        assert o["local_mesh"] == ((3, 1), ("data", "model"), 3, 3, r, "cpu")
        assert o["two_axis_mesh"] == []
        assert o["production"].startswith(
            "ValueError: the single-pod production mesh (16, 16) needs a "
            "world of 256 ranks, got 3")


# ---------------------------------------------------------------------------
# a failing rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", ("ensemble", "window", "exit"))
def test_a_failing_rank_fails_every_rank(where):
    """Rank 1 raises in its ensemble block or in a multicluster window (the
    next gather fails every rank), or dies in a window (rank 0 fails at
    the group's timeout): the world ends with every rank failed, within
    the limit."""
    with pytest.raises(WorldError) as info:
        _world(w.fail_on_rank_1, 2, where, group_timeout=15.0)
    failures = info.value.failures
    assert sorted(failures) == [0, 1]
    if where == "exit":
        assert "exited with code 3" in failures[1]
    else:
        assert "injected" in failures[1].splitlines()[-1]
        assert "rank 1 of the mesh failed" in failures[0].splitlines()[-1]
