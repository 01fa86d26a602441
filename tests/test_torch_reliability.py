"""Node failures of the PyTorch port against the JAX engine (DESIGN.md §15).

The port's ``FailureModel``/``merge_stream`` give the reference's arrays on
a grid of parameters; its engine runs (``device="cpu"``, the plain path of
the same code the card runs) equal ``repro.api.run`` and
``repro.api.run_ref`` bit for bit: every column, the reliability columns,
``n_events`` and the summary, over MTBF x kill rule x policy x
scalar/machine mode, the policies outside that grid, hand-built streams
with closed-form schedules, aborts on a DAG, and random streams.
"""

import dataclasses
import warnings

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st
from _torch_streams import assert_matches_jax, jax_spec

import repro_torch as rt
from repro import reliability as jrel
from repro.core.engine import simulate as jax_simulate
from repro.core.jobs import POLICY_IDS, make_jobset as jax_make_jobset
from repro_torch import reliability as rel
from repro_torch.core.engine import simulate
from repro_torch.core.jobs import INF_TIME, make_jobset

MTBFS = (300.0, 800.0, 2500.0)
POLICIES = ("fcfs", "sjf", "backfill")
REQUEUE_MODES = ("requeue", "abort")


def _model(mtbf, requeue="requeue", **kw):
    kw.setdefault("seed", 7)
    kw.setdefault("mean_repair", 50)
    kw.setdefault("horizon", 4000)
    kw.setdefault("max_failures", 32)
    kw.setdefault("checkpoint_interval", 20)
    kw.setdefault("restart_overhead", 5)
    return rt.FailureModel(mtbf=mtbf, requeue=requeue, **kw)


def _trace(n=60, seed=1):
    rng = np.random.default_rng(seed)
    return dict(submit=rng.integers(0, 400, n), runtime=rng.integers(5, 80, n),
                nodes=rng.integers(1, 6, n), estimate=rng.integers(5, 100, n))


def _scenario(mode, mtbf, requeue, policy, trace=None):
    trace = trace if trace is not None else _trace()
    kw = dict(trace=rt.ArrayTrace.from_dict(trace), policy=policy,
              failures=_model(mtbf, requeue))
    if mode == "scalar":
        return rt.Scenario(total_nodes=16, **kw)
    return rt.Scenario(topology=rt.Topology.mesh2d(4, 4), alloc="contiguous",
                       **kw)


def _run(scn):
    return rt.run(scn, device="cpu")


# ---------------------------------------------------------------------------
# models: the reference's arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist,k", [("exponential", 1.5), ("weibull", 0.7),
                                    ("weibull", 2.5)])
@pytest.mark.parametrize("mtbf,max_failures", [(120.0, 64), (500.0, 32),
                                               (5e3, 8), (1e12, 4)])
def test_materialize_and_merge_equal_the_reference(dist, k, mtbf,
                                                   max_failures):
    kw = dict(mtbf=mtbf, seed=3, distribution=dist, k=k, mean_repair=40,
              horizon=3000, max_failures=max_failures,
              requeue="abort", checkpoint_interval=15, restart_overhead=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a, b = rel.FailureModel(**kw).materialize(12), \
            jrel.FailureModel(**kw).materialize(12)
    for f in ("fail_time", "fail_node", "repair_time"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    for f in ("requeue", "checkpoint_interval", "restart_overhead",
              "n_failures", "truncated", "capacity"):
        assert getattr(a, f) == getattr(b, f)
    for x, y in zip(rel.merge_stream(a), jrel.merge_stream(b)):
        np.testing.assert_array_equal(x, y)
    ctx = rel.make_fail_ctx(a)
    np.testing.assert_array_equal(ctx.time, jrel.merge_stream(b)[0])
    assert (ctx.requeue, ctx.checkpoint_interval, ctx.restart_overhead,
            ctx.capacity) == (rel.ABORT, 15, 2, max_failures)
    assert rel.make_fail_ctx(ctx) is ctx
    assert rel.make_fail_ctx(None) is None
    assert rel.FailureModel(**kw).static_key() == \
        jrel.FailureModel(**kw).static_key()


def test_constants_equal_the_reference():
    assert (rel.FAIL, rel.REPAIR, rel.ABORT, rel.REQUEUE) == (
        jrel.FAIL, jrel.REPAIR, jrel.ABORT, jrel.REQUEUE)
    assert rel.REQUEUE_IDS == jrel.REQUEUE_IDS
    assert rel.REQUEUE_NAMES == jrel.REQUEUE_NAMES


def test_merge_stream_orders_fail_before_repair_on_ties():
    tr = rel.FailureTrace(
        fail_time=np.array([10, 20], np.int32),
        fail_node=np.array([0, 1], np.int32),
        repair_time=np.array([20, 30], np.int32),
        requeue=1, checkpoint_interval=0, restart_overhead=0, n_failures=2)
    t, node, kind = rel.merge_stream(tr)
    assert t.tolist() == [10, 20, 20, 30]
    assert kind.tolist() == [rel.FAIL, rel.FAIL, rel.REPAIR, rel.REPAIR]
    assert node.tolist() == [0, 1, 0, 1]
    np.testing.assert_array_equal(rel.make_fail_ctx(tr).kind, kind)


@pytest.mark.parametrize("kw,match", [
    (dict(mtbf=0.0), "mtbf"), (dict(mtbf=10.0, distribution="pareto"),
                               "distribution"),
    (dict(mtbf=10.0, k=0.0), "weibull shape"),
    (dict(mtbf=10.0, mean_repair=0), "mean_repair"),
    (dict(mtbf=10.0, requeue="retry"), "requeue"),
    (dict(mtbf=10.0, max_failures=-1), "max_failures"),
    (dict(mtbf=10.0, checkpoint_interval=-1), "checkpoint_interval"),
    (dict(mtbf=10.0, horizon=int(INF_TIME)), "horizon")])
def test_failure_model_validation_as_the_reference(kw, match):
    for mod in (rel, jrel):
        with pytest.raises(ValueError, match=match):
            mod.FailureModel(**kw)


def test_scenario_refuses_what_the_reference_refuses():
    with pytest.raises(TypeError, match="FailureModel"):
        rt.Scenario(trace=_trace(), total_nodes=16,
                    failures=_model(100.0).materialize(16))
    with pytest.raises(TypeError, match="fail ctx"):
        rel.make_fail_ctx(object())
    with pytest.raises(ValueError, match="total_nodes"):
        rel.make_fail_ctx(_model(100.0))


def test_truncation_is_flagged_and_warned_as_the_reference():
    kw = dict(mtbf=50.0, mean_repair=10, horizon=4000, max_failures=8)
    rel.model._materialize.cache_clear()
    with pytest.warns(UserWarning, match="keeping only the earliest") as w:
        tr = rel.FailureModel(**kw).materialize(16)
    jrel.model._materialize.cache_clear()
    try:
        with pytest.warns(UserWarning) as wj:
            jrel.FailureModel(**kw).materialize(16)
    finally:
        jrel.model._materialize.cache_clear()
    assert str(w[0].message) == str(wj[0].message)
    assert tr.truncated and tr.n_failures == 8
    assert not rel.FailureModel(mtbf=1e9, max_failures=8).materialize(
        16).truncated


# ---------------------------------------------------------------------------
# hand-built streams: closed-form schedules
# ---------------------------------------------------------------------------

def _one_failure(t_fail, node, t_repair, requeue=1, ckpt=0, overhead=0):
    return rel.FailureTrace(
        fail_time=np.array([t_fail], np.int32),
        fail_node=np.array([node], np.int32),
        repair_time=np.array([t_repair], np.int32),
        requeue=requeue, checkpoint_interval=ckpt, restart_overhead=overhead,
        n_failures=1)


def _jax_trace(ft):
    return jrel.FailureTrace(**{f.name: getattr(ft, f.name)
                                for f in dataclasses.fields(ft)})


def _both(trace, ft, total):
    """The port's and the JAX engine's results of one hand-built stream,
    scalar mode, fcfs."""
    port = simulate(make_jobset(**trace, total_nodes=total, device="cpu"),
                    "fcfs", total, failures=ft, device="cpu")
    ref = jax_simulate(jax_make_jobset(**trace, total_nodes=total),
                       POLICY_IDS["fcfs"], total, failures=_jax_trace(ft))
    for k in ("start", "finish", "ready", "done", "alloc_sum"):
        np.testing.assert_array_equal(getattr(port, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)
    for k in ("n_restarts", "lost_work", "aborted"):
        np.testing.assert_array_equal(getattr(port.rel, k).numpy(),
                                      np.asarray(getattr(ref.rel, k)), k)
    assert port.n_events == int(ref.n_events)
    assert port.makespan == int(ref.makespan)
    return port


def test_checkpoint_rework_closed_form():
    """Killed at t=50 with 20 s checkpoints: 10 s of rework and 5 s of
    overhead; the job waits out the repair (t=80) and ends at 145."""
    res = _both(dict(submit=[0], runtime=[100], nodes=[4]),
                _one_failure(50, 2, 80, ckpt=20, overhead=5), 4)
    assert int(res.finish[0]) == 145 and int(res.rel.n_restarts[0]) == 1
    assert int(res.rel.lost_work[0]) == 15 and not bool(res.rel.aborted[0])


def test_no_checkpoint_means_full_rework():
    res = _both(dict(submit=[0], runtime=[100], nodes=[4]),
                _one_failure(50, 0, 60), 4)
    assert int(res.finish[0]) == 160 and int(res.rel.lost_work[0]) == 50


def test_requeue_rejoins_at_submit_rank():
    res = _both(dict(submit=[0, 5], runtime=[100, 30], nodes=[4, 4]),
                _one_failure(50, 1, 55), 4)
    assert int(res.start[1]) == int(res.finish[0])


def test_abort_terminates_and_releases_dependents():
    """Under abort the victim is DONE at the kill time (not done, no part
    of the makespan) and its dependent releases at once."""
    res = _both(dict(submit=[0, 0], runtime=[100, 10], nodes=[4, 1],
                     deps=[(1, 0)]), _one_failure(40, 3, 90, requeue=0), 4)
    assert bool(res.rel.aborted[0]) and int(res.finish[0]) == 40
    assert not bool(res.done[0]) and bool(res.done[1])
    assert int(res.ready[1]) == 40
    assert res.makespan == int(res.finish[1])


def test_requeue_does_not_release_dependents_early():
    res = _both(dict(submit=[0, 0], runtime=[100, 10], nodes=[4, 1],
                     deps=[(1, 0)]), _one_failure(40, 3, 45, requeue=1), 4)
    assert int(res.finish[0]) == 145 and int(res.ready[1]) == 145


def test_idle_node_failure_shrinks_capacity_only():
    res = _both(dict(submit=[0, 10], runtime=[20, 20], nodes=[2, 4]),
                _one_failure(5, 2, 30), 4)
    assert int(res.rel.n_restarts.sum()) == 0 and int(res.start[1]) == 30


def test_down_node_is_never_placed_on_a_machine():
    """The failed node is painted busy until its repair: the 2-node job
    waits for job 0's nodes and lands on nodes 0 and 1."""
    trace = dict(submit=[0, 2], runtime=[50, 20], nodes=[2, 2])
    ft = _one_failure(1, 3, 100)
    port = simulate(make_jobset(**trace, total_nodes=4, device="cpu"),
                    "fcfs", 4, machine=rt.Topology.mesh2d(2, 2).build("cpu"),
                    alloc="simple", failures=ft, device="cpu")
    ref = jax_simulate(jax_make_jobset(**trace, total_nodes=4),
                       POLICY_IDS["fcfs"], 4,
                       machine=jax_spec(rt.Topology.mesh2d(2, 2)).build(),
                       alloc="simple", failures=_jax_trace(ft))
    assert int(port.start[1]) == 50 and int(port.alloc_first[1]) == 0
    for k in ("start", "finish", "alloc_sum", "ev_lfb", "ev_free"):
        np.testing.assert_array_equal(getattr(port, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)


def test_hand_built_no_op_entries_are_no_ops_on_a_machine():
    """A failure of a node that is down already and a repair of one that is
    up change nothing, as in the reference (its guards make the stream
    semantics total)."""
    trace = dict(submit=[0, 1, 2], runtime=[30, 30, 30], nodes=[2, 1, 1])
    ft = rel.FailureTrace(
        fail_time=np.array([5, 6, 60], np.int32),
        fail_node=np.array([3, 3, 1], np.int32),
        repair_time=np.array([40, 40, 61], np.int32), requeue=1,
        checkpoint_interval=0, restart_overhead=0, n_failures=3)
    port = simulate(make_jobset(**trace, total_nodes=4, device="cpu"),
                    "fcfs", 4, machine=rt.Topology.mesh2d(2, 2).build("cpu"),
                    failures=ft, device="cpu")
    ref = jax_simulate(jax_make_jobset(**trace, total_nodes=4),
                       POLICY_IDS["fcfs"], 4,
                       machine=jax_spec(rt.Topology.mesh2d(2, 2)).build(),
                       failures=_jax_trace(ft))
    for k in ("start", "finish", "ev_free", "ev_lfb"):
        np.testing.assert_array_equal(getattr(port, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)
    assert port.n_events == int(ref.n_events)


# ---------------------------------------------------------------------------
# the engine grid against run and run_ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("scalar", "mesh"))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("requeue", REQUEUE_MODES)
@pytest.mark.parametrize("mtbf", MTBFS)
def test_engine_grid_matches_jax(mtbf, requeue, policy, mode):
    """MTBF x kill rule x policy x scalar / mesh2d(4, 4) contiguous."""
    res = _run(_scenario(mode, mtbf, requeue, policy))
    assert_matches_jax(res)
    if mtbf == MTBFS[0]:
        kills = int(res["n_restarts"].sum()) + int(res["aborted"].sum())
        assert kills > 0


@pytest.mark.parametrize("policy", ("preempt", "bestfit", "ljf"))
def test_remaining_policies_scalar(policy):
    trace = _trace(seed=3)
    trace["priority"] = np.random.default_rng(3).integers(0, 3, 60)
    assert_matches_jax(_run(_scenario("scalar", 500.0, "requeue", policy,
                                      trace)))


@pytest.mark.parametrize("alloc", ("simple", "spread", "topo"))
@pytest.mark.parametrize("policy", ("fcfs", "backfill"))
def test_other_strategies_on_a_machine(policy, alloc):
    scn = _scenario("mesh", 300.0, "requeue", policy).with_(
        alloc=alloc, topology=rt.Topology.dragonfly(4, 4))
    assert_matches_jax(_run(scn))


@pytest.mark.parametrize("requeue", REQUEUE_MODES)
@pytest.mark.parametrize("policy", ("fcfs", "backfill", "sjf"))
@pytest.mark.parametrize("mode", ("scalar", "mesh"))
def test_dag_under_failures(mode, policy, requeue):
    """A montage DAG under failures: aborts release the victims'
    dependents (after-any), requeues release nothing early.  FCFS and SJF
    take the prefix pass in scalar mode."""
    fm = rt.FailureModel(mtbf=150.0, seed=4, mean_repair=30, horizon=3000,
                         max_failures=64, requeue=requeue)
    kw = (dict(total_nodes=16) if mode == "scalar" else
          dict(topology=rt.Topology.mesh2d(4, 4), alloc="contiguous"))
    scn = rt.Scenario(trace=rt.WorkflowTrace(kind="montage",
                                             params=(("width", 8),)),
                      policy=policy, failures=fm, **kw)
    res = _run(scn)
    assert_matches_jax(res)
    out = res.to_np()
    if requeue == "abort":
        assert out["aborted"].any()
    else:
        assert out["n_restarts"].sum() > 0 and out["done"][out["valid"]].all()


def test_zero_failure_stream_equals_failures_none():
    quiet = rt.FailureModel(mtbf=1e12, max_failures=8, horizon=1 << 19)
    assert quiet.materialize(16).n_failures == 0
    for policy in ("fcfs", "backfill"):
        base = rt.Scenario(trace=rt.ArrayTrace.from_dict(_trace(seed=5)),
                           total_nodes=16, policy=policy)
        a, b = _run(base), _run(base.with_(failures=quiet))
        for k in ("start", "finish", "n_events", "makespan", "done"):
            np.testing.assert_array_equal(a[k], b[k])
        assert int(b["n_restarts"].sum()) == 0
        assert a.raw.rel is None and "n_restarts" not in a.to_np()
        assert_matches_jax(b)


def test_reliability_summary_as_the_reference():
    s = _run(_scenario("scalar", 300.0, "requeue", "fcfs")).summary()
    assert 0.0 < s["goodput"] <= 1.0 and s["n_aborted"] == 0.0
    s = _run(_scenario("scalar", 300.0, "abort", "fcfs")).summary()
    assert s["n_aborted"] > 0
    assert "goodput" not in _run(rt.Scenario(
        trace=rt.SyntheticTrace(n_jobs=20), total_nodes=8)).summary()


def test_event_cap_grows_with_the_stream():
    """``6 J + 6 F + 8`` events by default; a ``max_events`` cut stops the
    run where the reference's does."""
    scn = _scenario("scalar", 300.0, "requeue", "backfill")
    res = _run(scn.with_(max_events=40))
    assert res["n_events"] == 40 and not res["done"][res["valid"]].all()
    assert_matches_jax(res, ref=False)


# ---------------------------------------------------------------------------
# random streams
# ---------------------------------------------------------------------------

@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       mtbf=st.sampled_from([150.0, 500.0, 2000.0]),
       requeue=st.sampled_from(REQUEUE_MODES),
       ckpt=st.sampled_from([0, 15, 40]),
       policy=st.sampled_from(POLICIES))
def test_random_streams_match_jax(seed, mtbf, requeue, ckpt, policy):
    """Random traces x random streams, scalar mode: the port equals the
    JAX engine and the reference simulator; elapsed time covers runtime
    plus the charged rework of every completed job."""
    rng = np.random.default_rng(seed)
    n = 40
    trace = dict(submit=rng.integers(0, 300, n), runtime=rng.integers(5, 60, n),
                 nodes=rng.integers(1, 5, n))
    fm = rt.FailureModel(mtbf=mtbf, seed=seed % 1000, mean_repair=40,
                         horizon=3000, max_failures=32, requeue=requeue,
                         checkpoint_interval=ckpt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = _run(rt.Scenario(trace=rt.ArrayTrace.from_dict(trace),
                               total_nodes=16, policy=policy, failures=fm))
        assert_matches_jax(res, summary=False)
    out = res.to_np()
    done = out["done"] & out["valid"]
    elapsed = (out["finish"] - out["start"])[done]
    assert (elapsed >= (out["runtime"] + out["lost_work"])[done]).all()


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_random_streams_on_a_machine_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 30
    trace = dict(submit=rng.integers(0, 200, n), runtime=rng.integers(5, 50, n),
                 nodes=rng.integers(1, 5, n))
    fm = rt.FailureModel(mtbf=300.0, seed=seed % 1000, mean_repair=30,
                         horizon=2000, max_failures=24)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert_matches_jax(_run(rt.Scenario(
            trace=rt.ArrayTrace.from_dict(trace),
            topology=rt.Topology.mesh2d(4, 4), policy="fcfs",
            alloc="contiguous", failures=fm)), summary=False)
