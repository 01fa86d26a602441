"""Failure streams and service plans in the port's ensembles and sweeps.

Each member of ``simulate_ensemble(failures_b=..., service_b=...)`` consumes
its own streams inside the lockstep event step and equals its solo run bit
for bit; ``sweep`` runs the reference's MTBF x kill rule, checkpoint and
rate x policy x autoscaler grids in one bucket each, every point equal to
``repro.api.run``; ``failures.max_failures`` and
``trace.autoscale.max_ticks`` split buckets, as in the reference.  Members
finish early (aborts end a member long before its neighbours), and a
``max_events`` cut stops every member where its solo run stops.
"""

import dataclasses
import warnings

import numpy as np
import pytest
from _torch_streams import assert_matches_jax, diff

import repro_torch as rt
from repro_torch.api import build_jobset
from repro_torch.core import engine
from repro_torch.core.jobs import make_jobset
from repro_torch.core.parallel import simulate_ensemble, stack_jobsets

FM = rt.FailureModel(mtbf=500.0, seed=7, mean_repair=50, horizon=4000,
                     max_failures=32, checkpoint_interval=20,
                     restart_overhead=5)
SCALER = rt.AutoscalePolicy(up_threshold=6, down_threshold=1, min_nodes=4,
                            max_nodes=16, step=2, interval=50, max_ticks=64)
TWO_CLASS = (
    rt.ServiceClass("small", nodes=1, mean_runtime=30, slo_wait=40),
    rt.ServiceClass("big", nodes=4, mean_runtime=120, dist="exponential",
                    slo_wait=200, weight=0.3),
)


def _trace(n=60, seed=1):
    rng = np.random.default_rng(seed)
    return rt.ArrayTrace(submit=rng.integers(0, 400, n),
                         runtime=rng.integers(5, 80, n),
                         nodes=rng.integers(1, 6, n),
                         estimate=rng.integers(5, 100, n))


def _service(rate=0.06, autoscale=SCALER):
    return rt.ServiceTrace(horizon=1500, rate=rate, seed=7, max_jobs=256,
                           classes=TWO_CLASS, autoscale=autoscale)


def _sweep(scn, axes):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rt.sweep(scn, axes=axes, device="cpu")


def _assert_members_match(grid, *, ref: bool = False):
    for point, res in grid:
        assert_matches_jax(res, ref=ref)
        solo = rt.run(res.scenario, device="cpu")
        assert diff(res.to_np(), solo.to_np()) == [], point


# ---------------------------------------------------------------------------
# simulate_ensemble
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("machine", (False, True), ids=("scalar", "mesh"))
def test_ensemble_failures_b_members_equal_solo(machine):
    """One fail spec a member (models, traces and ctxs mixed), members of
    different policies: each equals its solo run."""
    jobs = make_jobset(**{k: getattr(_trace(n=40, seed=2), k) for k in
                          ("submit", "runtime", "nodes", "estimate")},
                       total_nodes=16, device="cpu")
    models = [dataclasses.replace(FM, mtbf=m, requeue=r) for m, r in
              ((300.0, "requeue"), (900.0, "abort"), (2500.0, "requeue"))]
    specs = [models[0], models[1].materialize(16),
             rt.reliability.make_fail_ctx(models[2], n_nodes=16)]
    pols = ["fcfs", "backfill", "sjf"]
    kw = {}
    if machine:
        kw = dict(machine=rt.Topology.mesh2d(4, 4).build("cpu"),
                  alloc_b=["contiguous", "simple", "topo"])
    batched = simulate_ensemble(stack_jobsets([jobs] * 3), pols, [16] * 3,
                                failures_b=specs, device="cpu", **kw)
    for b, (m, p) in enumerate(zip(models, pols)):
        solo_kw = {} if not machine else dict(machine=kw["machine"],
                                              alloc=kw["alloc_b"][b])
        solo = engine.simulate(jobs, p, 16, failures=m, device="cpu",
                               **solo_kw)
        got = batched.member(b)
        for k in ("start", "finish", "done", "alloc_sum", "ev_lfb"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          getattr(solo, k).numpy(), k)
        for k in ("n_restarts", "lost_work", "aborted"):
            np.testing.assert_array_equal(getattr(got.rel, k).numpy(),
                                          getattr(solo.rel, k).numpy(), k)
        assert got.n_events == solo.n_events
        assert got.makespan == solo.makespan


def test_ensemble_one_spec_for_every_member():
    jobs = build_jobset(rt.Scenario(trace=_trace(), total_nodes=16),
                        device="cpu")
    a = simulate_ensemble(stack_jobsets([jobs] * 2), ["fcfs", "backfill"],
                          [16, 16], failures_b=FM, device="cpu")
    b = simulate_ensemble(stack_jobsets([jobs] * 2), ["fcfs", "backfill"],
                          [16, 16], failures_b=[FM, FM], device="cpu")
    np.testing.assert_array_equal(a.finish.numpy(), b.finish.numpy())
    assert a.n_events == b.n_events
    with pytest.raises(ValueError, match="stream specs"):
        simulate_ensemble(stack_jobsets([jobs] * 2), ["fcfs"] * 2, [16, 16],
                          failures_b=[FM], device="cpu")


def test_ensemble_service_b_members_equal_solo():
    specs = [_service(0.03), _service(0.11),
             _service(0.06, dataclasses.replace(SCALER, enabled=False))]
    jobs = [build_jobset(rt.Scenario(trace=s, total_nodes=16), device="cpu")
            for s in specs]
    batched = simulate_ensemble(stack_jobsets(jobs), ["fcfs", "sjf", "fcfs"],
                                [16] * 3, service_b=specs, device="cpu")
    for b, (s, p) in enumerate(zip(specs, ["fcfs", "sjf", "fcfs"])):
        solo = engine.simulate(jobs[b], p, 16, service=s, device="cpu")
        got = batched.member(b)
        for k in ("start", "finish", "done"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          getattr(solo, k).numpy(), k)
        for k in ("slo_met", "deadline", "cap_online"):
            np.testing.assert_array_equal(getattr(got.svc, k).numpy(),
                                          getattr(solo.svc, k).numpy(), k)
        assert got.n_events == solo.n_events


# ---------------------------------------------------------------------------
# sweeps: one bucket each, every point equal to JAX and to its solo run
# ---------------------------------------------------------------------------

def test_mtbf_requeue_sweep_is_one_bucket():
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=50, seed=0,
                                              kind="sdsc_sp2", congest=4),
                      total_nodes=32, policy="fcfs", failures=FM)
    grid = _sweep(scn, {"failures.mtbf": (200.0, 600.0, 3000.0),
                        "failures.requeue": ("requeue", "abort")})
    assert grid.n_compiles == 1 and len(grid) == 6
    _assert_members_match(grid, ref=True)
    assert any(s["total_restarts"] > 0 for s in grid.summaries())


def test_checkpoint_and_policy_axes_share_a_bucket():
    scn = rt.Scenario(trace=_trace(), total_nodes=16, policy="backfill",
                      failures=FM)
    grid = _sweep(scn, {"failures.checkpoint_interval": (0, 20, 200),
                        "failures.restart_overhead": (0, 7),
                        "policy": ("backfill", "sjf", "preempt")})
    assert grid.n_compiles == 1 and len(grid) == 18
    _assert_members_match(grid)


def test_total_nodes_stays_ensemble_data_with_failures():
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=30, seed=0),
                      total_nodes=16, failures=FM)
    grid = _sweep(scn, {"total_nodes": (12, 16, 24),
                        "failures.mtbf": (400.0, 2500.0)})
    assert grid.n_compiles == 1
    _assert_members_match(grid)


def test_machine_mode_failure_sweep():
    scn = rt.Scenario(trace=_trace(), topology=rt.Topology.mesh2d(4, 4),
                      failures=FM)
    grid = _sweep(scn, {"failures.mtbf": (300.0, 2500.0),
                        "failures.requeue": ("requeue", "abort"),
                        "policy": ("fcfs", "backfill"),
                        "alloc": ("simple", "contiguous")})
    assert grid.n_compiles == 1 and len(grid) == 16
    _assert_members_match(grid)


def test_dag_abort_sweep_members_finish_early():
    """Aborts end a DAG member long before the requeue members; the
    finished member's streams are not drained and its state stays as its
    solo run left it."""
    scn = rt.Scenario(trace=rt.WorkflowTrace(kind="montage",
                                             params=(("width", 8),)),
                      total_nodes=8, policy="fcfs",
                      failures=dataclasses.replace(FM, mtbf=150.0,
                                                   max_failures=64,
                                                   horizon=3000))
    grid = _sweep(scn, {"failures.requeue": ("requeue", "abort"),
                        "policy": ("fcfs", "backfill")})
    assert grid.n_compiles == 1
    _assert_members_match(grid)
    ev = {(p["failures.requeue"], p["policy"]): r["n_events"]
          for p, r in grid}
    for policy in ("fcfs", "backfill"):
        assert ev[("abort", policy)] < ev[("requeue", policy)]


def test_max_events_cut_in_a_stream_sweep():
    scn = rt.Scenario(trace=_trace(), total_nodes=16, failures=FM,
                      max_events=70)
    grid = _sweep(scn, {"failures.mtbf": (300.0, 2500.0),
                        "policy": ("fcfs", "backfill")})
    assert all(r["n_events"] == 70 for r in grid.results)
    _assert_members_match(grid)


def test_rate_policy_autoscale_sweep_is_one_bucket():
    scn = rt.Scenario(trace=_service(), total_nodes=16, policy="fcfs")
    grid = _sweep(scn, {
        "trace.rate": (0.03, 0.07, 0.11),
        "policy": ("fcfs", "sjf"),
        "trace.autoscale": (SCALER, dataclasses.replace(SCALER,
                                                        enabled=False)),
        "trace.seed": (0, 1)})
    assert grid.n_compiles == 1 and len(grid) == 24
    reqs = {r.summary()["n_requests"] for r in grid.results}
    assert len(reqs) > 1          # rate points are distinct traffic
    _assert_members_match(grid)


def test_serving_sweep_on_a_machine():
    scn = rt.Scenario(trace=_service(), topology=rt.Topology.mesh2d(4, 4))
    grid = _sweep(scn, {"trace.rate": (0.03, 0.11),
                        "policy": ("fcfs", "backfill"),
                        "alloc": ("simple", "contiguous")})
    assert grid.n_compiles == 1
    _assert_members_match(grid)


def test_failures_and_service_compose_in_a_sweep():
    scn = rt.Scenario(trace=_service(), total_nodes=16,
                      failures=dataclasses.replace(FM, horizon=1500))
    grid = _sweep(scn, {"trace.rate": (0.03, 0.11),
                        "failures.mtbf": (300.0, 2500.0)})
    assert grid.n_compiles == 1
    _assert_members_match(grid)


@pytest.mark.parametrize("axes,buckets", [
    ({"failures.max_failures": (16, 32)}, 2),
    ({"failures.max_failures": (16, 32), "failures.mtbf": (300.0, 900.0)},
     2)])
def test_max_failures_splits_buckets(axes, buckets):
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=30, seed=0),
                      total_nodes=16, failures=FM)
    grid = _sweep(scn, axes)
    assert grid.n_compiles == buckets
    _assert_members_match(grid)


def test_max_ticks_splits_buckets():
    scn = rt.Scenario(trace=_service(), total_nodes=16, policy="fcfs")
    grid = _sweep(scn, {"trace.autoscale": (
        SCALER, dataclasses.replace(SCALER, max_ticks=32))})
    assert grid.n_compiles == 2
    _assert_members_match(grid)


def test_ensemble_streams_need_one_shape():
    """Members share one event cap and one capacity log, so their streams
    must share one shape, as the reference's stacked streams do."""
    jobs = build_jobset(rt.Scenario(trace=_trace(), total_nodes=16),
                        device="cpu")
    with pytest.raises(ValueError, match="failure capacities"):
        simulate_ensemble(stack_jobsets([jobs] * 2), ["fcfs"] * 2, [16, 16],
                          failures_b=[FM, dataclasses.replace(
                              FM, max_failures=16)], device="cpu")
    specs = [_service(), _service(autoscale=dataclasses.replace(
        SCALER, max_ticks=32))]
    tables = [build_jobset(rt.Scenario(trace=s, total_nodes=16),
                           device="cpu") for s in specs]
    with pytest.raises(ValueError, match="tick counts"):
        simulate_ensemble(stack_jobsets(tables), ["fcfs"] * 2, [16, 16],
                          service_b=specs, device="cpu")
