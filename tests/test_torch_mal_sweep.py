"""Malleable jobs in the port's ensembles and sweeps, on the CPU.

- ``tests/test_malleable.py``'s sweep grid: curve x param x shrink
  threshold (8 points) is one bucket, and every member equals its solo run
  and the JAX ``sweep``'s member; the width range and the mode split
  buckets (three), each point equal to the reference simulator's run;
- ``simulate_ensemble(malleable_b=)`` on ragged batches (members of
  different job counts padded to one capacity, different policies, node
  counts and curves), in scalar mode and on a machine, member by member
  equal to the solo runs (the JAX engine's, or the port's where the JAX
  package has no malleable ensemble on a machine, the port's solo runs
  being held to ``repro.api.run`` in ``test_torch_malleable.py``);
- elastic jobs under failures through ``sweep``: one bucket, each member
  equal to its solo run and to the JAX engine, with widths from 1 and
  from 3.
"""

import dataclasses

import numpy as np
import pytest
from _torch_streams import diff, jax_spec

import repro_torch as rt
from repro import api

POWER_ELAST = dict(curve="power", param=0.7, min_width=1, max_width=8,
                   mode="elastic", interval=30, max_ticks=64,
                   shrink_threshold=8, grow_threshold=2, step=2)
AMDAHL_MOLD = dict(curve="amdahl", param=0.2, min_width=1, max_width=8,
                   mode="moldable")


def _scenario(mod, mal, n_jobs=60, policy="backfill", **kw):
    return mod.Scenario(trace=mod.SyntheticTrace(n_jobs=n_jobs, seed=0,
                                                 congest=4),
                        total_nodes=32, policy=policy,
                        malleable=mod.MalleableModel(**mal), **kw)


def test_curve_sweep_is_one_bucket_equal_to_solo_and_jax():
    axes = {"malleable.curve": ("amdahl", "power"),
            "malleable.param": (0.2, 0.5),
            "malleable.shrink_threshold": (6, 10)}
    rt.reset_cache_stats(clear=True)
    grid = rt.sweep(_scenario(rt, POWER_ELAST), axes=axes, device="cpu")
    assert grid.n_compiles == 1 and len(grid) == 8
    assert rt.cache_stats().compiles == 1
    jgrid = api.sweep(_scenario(api, POWER_ELAST), axes=axes)
    widths = set()
    for (point, res), (jpoint, jres) in zip(grid, jgrid):
        assert point == jpoint
        got = res.to_np()
        assert diff(got, jres.to_np()) == [], point
        assert diff(got, rt.run(res.scenario, device="cpu").to_np()) == []
        assert res.summary() == jres.summary()
        widths.add(tuple(got["mal_width"].tolist()))
    assert len(widths) > 1      # the curves steer different widths


def test_width_range_and_mode_are_static_axes():
    mold = rt.MalleableModel(**AMDAHL_MOLD)
    models = (mold, dataclasses.replace(mold, max_width=16),
              rt.MalleableModel(**POWER_ELAST))
    grid = rt.sweep(_scenario(rt, AMDAHL_MOLD, n_jobs=40),
                    axes={"malleable": models}, device="cpu")
    assert grid.n_compiles == 3
    for point, res in grid:
        ref = api.run_ref(jax_spec(res.scenario)).to_np()
        assert diff(res.to_np(), ref, ["start", "finish", "mal_width",
                                       "mal_node_s", "mal_dur"]) == [], point


def _ragged(mod, machine: bool):
    """Four members: job counts 40-75 padded to 80 rows, and different
    policies, node counts (scalar mode) or strategies (machine) and
    curves, all elastic with one tick count."""
    mals = [POWER_ELAST, dict(POWER_ELAST, curve="amdahl", param=0.1),
            dict(POWER_ELAST, param=0.4, step=1, shrink_threshold=4),
            dict(POWER_ELAST, curve="table", param=0.1,
                 table=(1.0, 0.95, 0.9, 0.85, 0.8, 0.7, 0.6, 0.5))]
    out = []
    for b, (n, pol, nodes, alloc, mal) in enumerate(zip(
            (40, 75, 60, 52), ("fcfs", "backfill", "sjf", "bestfit"),
            (24, 32, 40, 32), ("contiguous", "spread", "simple", "topo"),
            mals)):
        kw = (dict(topology=mod.Topology.mesh2d(4, 8), alloc=alloc)
              if machine else dict(total_nodes=nodes))
        out.append(mod.Scenario(
            trace=mod.SyntheticTrace(n_jobs=n, seed=b, congest=4),
            policy=pol, capacity=80, malleable=mod.MalleableModel(**mal),
            **kw))
    return out


@pytest.mark.parametrize("machine", (False, True), ids=("scalar", "mesh2d"))
def test_ensemble_on_a_ragged_batch_matches_member_by_member(machine):
    from repro_torch.api.run import _mal_plan
    scns = _ragged(rt, machine)
    jobs = rt.stack_jobsets([rt.api.build_jobset(s, device="cpu")
                             for s in scns])
    kw = {}
    if machine:
        kw = dict(machine=scns[0].topology.build("cpu"),
                  alloc_b=[s.alloc for s in scns])
    res = rt.simulate_ensemble(
        jobs, [s.policy for s in scns], [int(s.total_nodes) for s in scns],
        malleable_b=[_mal_plan(s) for s in scns], device="cpu", **kw)
    for b, scn in enumerate(scns):
        got = rt.Result(scenario=scn, raw=res.member(b),
                        jobs=jobs.member(b)).to_np()
        solo = rt.run(scn, device="cpu").to_np()
        assert diff(got, solo) == [], b
        if not machine:
            assert diff(got, api.run(jax_spec(scn)).to_np()) == [], b
        assert got["mal_nresize"].sum() > 0


def test_ensemble_refuses_what_simulate_refuses():
    from repro_torch.api.run import _mal_plan
    scns = _ragged(rt, False)[:2]
    jobs = rt.stack_jobsets([rt.api.build_jobset(s, device="cpu")
                             for s in scns])
    plans = [_mal_plan(s) for s in scns]
    with pytest.raises(ValueError, match="preempt"):
        rt.simulate_ensemble(jobs, ["fcfs", "preempt"], [32, 32],
                             malleable_b=plans, device="cpu")
    with pytest.raises(ValueError, match="contention"):
        rt.simulate_ensemble(jobs, ["fcfs", "fcfs"], [32, 32],
                             machine=rt.Topology.mesh2d(4, 8).build("cpu"),
                             contention=(1, 5), malleable_b=plans,
                             device="cpu")
    mold = dataclasses.replace(scns[1], malleable=rt.MalleableModel(
        **AMDAHL_MOLD))
    with pytest.raises(ValueError, match="resize tick counts"):
        rt.simulate_ensemble(jobs, ["fcfs", "fcfs"], [32, 32],
                             malleable_b=[plans[0], _mal_plan(mold)],
                             device="cpu")


def test_elastic_failure_sweep_is_one_bucket_equal_to_solo_and_jax():
    fm = dict(mtbf=400.0, seed=3, mean_repair=50, horizon=4000,
              max_failures=400)
    axes = {"failures.requeue": ("requeue", "abort"),
            "malleable.param": (0.3, 0.9)}
    grid = rt.sweep(_scenario(rt, POWER_ELAST,
                              failures=rt.FailureModel(**fm)),
                    axes=axes, device="cpu")
    assert grid.n_compiles == 1
    for point, res in grid:
        got = res.to_np()
        assert diff(got, rt.run(res.scenario, device="cpu").to_np()) == []
        assert diff(got, api.run(jax_spec(res.scenario)).to_np()) == [], \
            point
        assert got["mal_nresize"].sum() > 0
        assert np.asarray(got["n_restarts"]).sum() > 0 or \
            np.asarray(got["aborted"]).sum() > 0


@pytest.mark.parametrize("machine", (False, True), ids=("scalar", "mesh2d"))
def test_min_width_above_one_sweep_equal_to_solo_and_jax(machine):
    """Widths 3-8 under failures through ``sweep``: the batched engine's
    dispatch offsets, failure shrinks above ``min_width`` and requeues back
    to it, member by member equal to the solo run and to the JAX engine."""
    mal = dict(POWER_ELAST, curve="amdahl", param=0.1, min_width=3)
    kw = (dict(total_nodes=None, topology=rt.Topology.mesh2d(4, 8),
               alloc="contiguous") if machine else {})
    scn = _scenario(rt, mal, failures=rt.FailureModel(
        mtbf=400.0, seed=3, mean_repair=50, horizon=4000,
        max_failures=400)).with_(**kw)
    grid = rt.sweep(scn, axes={"policy": ("fcfs", "backfill"),
                               "malleable.param": (0.1, 0.4)},
                    device="cpu")
    assert grid.n_compiles == 1
    for point, res in grid:
        got = res.to_np()
        assert diff(got, rt.run(res.scenario, device="cpu").to_np()) == []
        assert diff(got, api.run(jax_spec(res.scenario)).to_np()) == [], \
            point
        assert got["mal_width"][got["valid"]].min() >= 3
        assert got["mal_nresize"].sum() > 0
        assert np.asarray(got["n_restarts"]).sum() > 0
