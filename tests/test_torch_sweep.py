"""``repro_torch.sweep`` (on the CPU) against ``repro.api.sweep``.

The port partitions a grid into the same static buckets as the reference,
so ``points`` and ``n_compiles`` agree on the same grid, and every point
equals the reference's bit for bit in ``start``, ``finish``, ``n_events``,
``makespan`` and ``done``.  ``total_nodes``, ``policy`` and ``trace.seed``
are data (one bucket); ``trace.n_jobs`` and ``capacity`` are static.  Also:
``cache_stats`` cold and warm, ``Scenario.with_`` and the trace specs'
bucket keys, and the errors of what is not ported.
"""

import os

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro import api

POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
# the six policies in two grids of three, so that a bucket of policy x two
# node counts holds six members
POLICY_HALVES = (POLICIES[:3], POLICIES[3:])
KEYS = ("start", "finish", "n_events", "makespan", "done")
TINY_SWF = os.path.join(os.path.dirname(__file__), "data", "tiny.swf")


def _both(trace, axes, **kw):
    port = rt.sweep(rt.Scenario(trace=getattr(rt, type(trace).__name__)(
        **trace.__dict__), **kw), axes=axes, device="cpu")
    ref = api.sweep(api.Scenario(trace=trace, **kw), axes=axes)
    assert port.points == ref.points
    assert port.n_compiles == ref.n_compiles
    for (point, a), (_, b) in zip(port, ref):
        for k in KEYS:
            np.testing.assert_array_equal(a.to_np()[k], b.to_np()[k],
                                          err_msg=f"{point} {k}")
        assert a.scenario.policy == point.get("policy", a.scenario.policy)
    return port, ref


def _synthetic(**kw):
    return api.SyntheticTrace(**{"n_jobs": 90, "seed": 2, "kind": "das2",
                                 "congest": 4, **kw})


@pytest.mark.parametrize("policies", POLICY_HALVES)
@pytest.mark.parametrize("kind,nodes", [("das2", (32, 64)),
                                        ("sdsc_sp2", (64, 128))])
def test_policy_by_nodes_grid_matches_jax(kind, nodes, policies):
    port, _ = _both(_synthetic(kind=kind), {"policy": policies,
                                            "total_nodes": nodes},
                    total_nodes=nodes[0], policy="fcfs")
    assert port.n_compiles == 1 and len(port) == 6


def test_seed_axis_matches_jax():
    port, _ = _both(_synthetic(), {"trace.seed": (0, 1, 2),
                                   "policy": ("backfill", "preempt")},
                    total_nodes=48, policy="fcfs")
    assert port.n_compiles == 1
    a = port.get(policy="backfill", **{"trace.seed": 0}).to_np()
    b = port.get(policy="backfill", **{"trace.seed": 1}).to_np()
    assert not np.array_equal(a["submit"], b["submit"])


def test_static_axes_split_buckets_like_jax():
    port, _ = _both(_synthetic(), {"trace.n_jobs": (60, 90),
                                   "policy": ("fcfs", "backfill"),
                                   "capacity": (None, 128)},
                    total_nodes=48, policy="fcfs")
    assert port.n_compiles == 4 and len(port) == 8


def test_max_events_grid_matches_jax():
    _both(_synthetic(), {"policy": ("sjf", "backfill")}, total_nodes=32,
          policy="fcfs", max_events=40)


def test_swf_sweep_matches_jax():
    port = rt.sweep(rt.Scenario(trace=rt.SwfTrace(TINY_SWF), total_nodes=64),
                    axes={"policy": POLICIES}, device="cpu")
    ref = api.sweep(api.Scenario(trace=api.SwfTrace(TINY_SWF),
                                 total_nodes=64), axes={"policy": POLICIES})
    assert port.n_compiles == ref.n_compiles == 1
    for (_, a), (_, b) in zip(port, ref):
        for k in KEYS:
            np.testing.assert_array_equal(a.to_np()[k], b.to_np()[k])


@pytest.mark.parametrize("policies", POLICY_HALVES)
def test_every_point_equals_its_solo_run(policies):
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=120, seed=3,
                                              kind="sdsc_sp2", congest=4),
                      total_nodes=128)
    grid = rt.sweep(scn, axes={"policy": policies, "total_nodes": (64, 128)},
                    device="cpu")
    for point, res in grid:
        solo = rt.run(scn.with_(**point), device="cpu")
        for k in KEYS + ("wait", "nodes", "valid"):
            np.testing.assert_array_equal(res.to_np()[k], solo.to_np()[k])
        assert res.summary() == solo.summary()


def test_empty_axes_degenerate_to_run():
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=50, seed=1),
                      total_nodes=32, policy="sjf")
    grid = rt.sweep(scn, axes={}, device="cpu")
    assert len(grid) == 1 and grid.n_compiles == 1 and grid.points == [{}]
    np.testing.assert_array_equal(grid[0].to_np()["start"],
                                  rt.run(scn, device="cpu").to_np()["start"])


def test_sweep_result_accessors():
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=60, seed=1,
                                              kind="das2"), total_nodes=32)
    grid = rt.sweep(scn, axes={"policy": ("fcfs", "backfill"),
                               "total_nodes": (16, 32)}, device="cpu")
    rows = grid.summaries()
    assert [(r["policy"], r["total_nodes"]) for r in rows] == [
        ("fcfs", 16), ("fcfs", 32), ("backfill", 16), ("backfill", 32)]
    assert all(r["n_jobs"] == 60 for r in rows)
    assert grid.stack("start").shape == (4, 60)
    assert grid.get(policy="backfill", total_nodes=16) is grid[2]
    with pytest.raises(KeyError):
        grid.get(policy="backfill")


def test_array_traces_never_collide():
    """Array traces key their buckets by identity: two equal-looking
    traces with different data are two buckets, as in the reference."""
    rng = np.random.default_rng(0)

    def arrays():
        return {"submit": rng.integers(0, 500, 40),
                "runtime": rng.integers(1, 90, 40),
                "nodes": rng.integers(1, 16, 40)}
    a, b = rt.ArrayTrace(**arrays()), rt.ArrayTrace(**arrays())
    assert a.static_key() != b.static_key() and a.n_rows == 40
    grid = rt.sweep(rt.Scenario(trace=a, total_nodes=16),
                    axes={"trace": (a, b), "policy": ("fcfs", "backfill")},
                    device="cpu")
    assert grid.n_compiles == 2
    for point, res in grid:
        solo = rt.run(rt.Scenario(trace=point["trace"], total_nodes=16,
                                  policy=point["policy"]), device="cpu")
        np.testing.assert_array_equal(res.to_np()["start"],
                                      solo.to_np()["start"])


def test_cache_stats_cold_and_warm():
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=40, seed=8),
                      total_nodes=16)
    axes = {"policy": ("fcfs", "sjf"), "trace.n_jobs": (40, 50)}
    rt.reset_cache_stats(clear=True)
    assert rt.cache_stats() == rt.SweepCacheStats(0, 0, 0)
    rt.sweep(scn, axes=axes, device="cpu")
    assert rt.cache_stats() == rt.SweepCacheStats(compiles=2, hits=0,
                                                  entries=2)
    rt.sweep(scn, axes=axes, device="cpu")
    assert rt.cache_stats() == rt.SweepCacheStats(compiles=2, hits=2,
                                                  entries=2)
    rt.reset_cache_stats()
    assert rt.cache_stats() == rt.SweepCacheStats(0, 0, 2)
    # the same bucket and shapes (two 40-job members): a hit
    rt.sweep(scn, axes={"policy": ("ljf", "bestfit")}, device="cpu")
    assert rt.cache_stats() == rt.SweepCacheStats(0, 1, 2)
    # the same bucket with one member: other shapes, so a compile
    rt.sweep(scn, axes={"policy": ("ljf",)}, device="cpu")
    assert rt.cache_stats() == rt.SweepCacheStats(1, 1, 3)
    rt.reset_cache_stats(clear=True)
    rt.sweep(scn, axes={"policy": ("ljf",)}, device="cpu")
    assert rt.cache_stats() == rt.SweepCacheStats(1, 0, 1)


def test_scenario_with_and_trace_keys_match_jax():
    kw = dict(n_jobs=30, seed=4, kind="sdsc_sp2", congest=2)
    port = rt.Scenario(trace=rt.SyntheticTrace(**kw), total_nodes=64)
    ref = api.Scenario(trace=api.SyntheticTrace(**kw), total_nodes=64)
    over = {"policy": "ljf", "trace.seed": 9, "total_nodes": 32}
    p, r = port.with_(**over), ref.with_(**over)
    assert (p.policy, p.total_nodes, p.trace.seed) == ("ljf", 32, 9)
    assert p.trace.static_key() == r.trace.static_key()
    assert p.trace.n_rows == r.trace.n_rows == 30
    assert p.trace_specs() == (p.trace,) and p.nodes_per_cluster() == (32,)
    assert port.trace.seed == 4          # with_ leaves the original as it was
    swf = rt.SwfTrace(TINY_SWF, max_jobs=5)
    assert swf.static_key() == api.SwfTrace(TINY_SWF, max_jobs=5).static_key()
    assert swf.n_rows is None
    with pytest.raises(ValueError, match="no capacity"):
        port.with_(**{"capacity.x": 1})


def test_unported_sweep_arguments_raise():
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=10), total_nodes=8)
    with pytest.raises(NotImplementedError, match="item 12"):
        rt.sweep(scn, axes={"policy": ("fcfs",)}, mesh=object(), device="cpu")
    # the failures axis, refused before the reliability slice, runs; a
    # value that is no FailureModel is refused as in the reference
    with pytest.raises(TypeError, match="FailureModel"):
        rt.sweep(scn, axes={"failures": (object(),)}, device="cpu")
    fm = [rt.FailureModel(mtbf=m, max_failures=16, horizon=2000)
          for m in (300.0, 3000.0)]
    grid = rt.sweep(scn, axes={"failures": fm}, device="cpu")
    assert grid.n_compiles == 1 and "n_restarts" in grid[0].to_np()
    for f, res in zip(fm, grid.results):
        want = api.run(api.Scenario(
            trace=api.SyntheticTrace(n_jobs=10), total_nodes=8,
            failures=api.FailureModel(mtbf=f.mtbf, max_failures=16,
                                      horizon=2000))).to_np()
        for k in want:
            np.testing.assert_array_equal(res.to_np()[k], want[k], k)
    # the alloc axis, refused before the allocation slice, runs with a
    # topology and is still refused without one, as in the reference
    with pytest.raises(ValueError, match="require topology"):
        rt.sweep(scn, axes={"alloc": ("simple", "topo")}, device="cpu")
    grid = rt.sweep(scn.with_(topology=rt.Topology.linear(8)),
                    axes={"alloc": ("simple", "topo")}, device="cpu")
    assert grid.n_compiles == 1 and "alloc_sum" in grid[1].to_np()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rt.sweep(scn, axes={"policy": ("fcfs",)})
