"""Online serving of the PyTorch port against the JAX engine (DESIGN.md §16).

The port's ``ServiceTrace.plan()`` gives the reference's arrays (Poisson
and trace-driven arrivals, autoscaler on, disabled and absent), and its
engine runs (``device="cpu"``) equal ``repro.api.run`` and
``repro.api.run_ref`` bit for bit: every column (SLO verdicts, deadlines,
classes, the capacity log), ``n_events`` and the summary, over rates x one
and two classes x autoscaler on/off x fcfs/sjf x scalar/``mesh2d(4, 4)``,
the tie order of one instant, and failures composed with the autoscaler.
"""

import dataclasses
import warnings

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st
from _torch_streams import assert_matches_jax, jax_spec

import repro_torch as rt
from repro import serving as jsvc
from repro_torch import serving as svc
from repro_torch.core.jobs import INF_TIME

RATES = (0.02, 0.06, 0.11)
POLICIES = ("fcfs", "sjf")
ONE_CLASS = (rt.ServiceClass("default", nodes=1, mean_runtime=45,
                             slo_wait=60),)
TWO_CLASS = (
    rt.ServiceClass("small", nodes=1, mean_runtime=30, slo_wait=40),
    rt.ServiceClass("big", nodes=4, mean_runtime=120, dist="exponential",
                    slo_wait=200, weight=0.3),
)
SCALER = rt.AutoscalePolicy(up_threshold=6, down_threshold=1, min_nodes=4,
                            max_nodes=16, step=2, interval=50, max_ticks=64)
AUTOSCALES = (SCALER, dataclasses.replace(SCALER, enabled=False))


def _spec(rate=0.06, classes=TWO_CLASS, autoscale=SCALER, **kw):
    kw.setdefault("horizon", 1500)
    kw.setdefault("seed", 7)
    kw.setdefault("max_jobs", 256)
    return rt.ServiceTrace(rate=rate, classes=classes, autoscale=autoscale,
                           **kw)


def _scenario(mode, rate, classes, autoscale, policy):
    kw = dict(policy=policy)
    if mode == "mesh2d":
        kw.update(topology=rt.Topology.mesh2d(4, 4), alloc="simple")
    else:
        kw.update(total_nodes=16)
    return rt.Scenario(trace=_spec(rate, classes, autoscale), **kw)


def _run(scn):
    return rt.run(scn, device="cpu")


# ---------------------------------------------------------------------------
# the plan: the reference's arrays
# ---------------------------------------------------------------------------

PLAN_FIELDS = ("submit", "runtime", "nodes", "estimate", "deadline",
               "class_id", "tick_time")
PLAN_SCALARS = ("class_names", "up_threshold", "down_threshold", "step",
                "min_nodes", "max_nodes", "interval", "n_requests",
                "truncated", "capacity")


@pytest.mark.parametrize("autoscale", (SCALER, AUTOSCALES[1], None),
                         ids=("on", "disabled", "absent"))
@pytest.mark.parametrize("classes", (ONE_CLASS, TWO_CLASS),
                         ids=("one_class", "two_class"))
@pytest.mark.parametrize("arrivals", (None, ((3, 0), (3, 1), (10, 0),
                                             (700, 1), (1499, 0))),
                         ids=("poisson", "trace"))
@pytest.mark.parametrize("rate", (0.01, 0.11))
def test_plan_equals_the_reference(rate, arrivals, classes, autoscale):
    if arrivals is not None and len(classes) == 1:
        arrivals = tuple((t, 0) for t, _ in arrivals)
    spec = _spec(rate, classes, autoscale, arrivals=arrivals)
    a, b = spec.plan(), jax_spec(spec).plan()
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert getattr(a, f).dtype == getattr(b, f).dtype
    for f in PLAN_SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    assert spec.static_key() == jax_spec(spec).static_key()
    assert spec.pad_capacity == 256 and spec.n_rows == a.n_requests
    for k, v in spec.materialize().items():
        np.testing.assert_array_equal(v, jax_spec(spec).materialize()[k])
    ctx = svc.make_svc_ctx(spec, n_nodes=12)
    assert ctx.max_nodes == (min(SCALER.max_nodes, 12)
                             if autoscale is not None else 12)
    np.testing.assert_array_equal(ctx.deadline, a.deadline)


def test_svc_ctx_clamps_max_nodes_to_the_machine():
    spec = _spec(autoscale=dataclasses.replace(SCALER, max_nodes=None))
    assert svc.make_svc_ctx(spec, n_nodes=16).max_nodes == 16
    assert svc.make_svc_ctx(spec).max_nodes == int(INF_TIME)
    ctx = svc.make_svc_ctx(spec, n_nodes=16)
    assert svc.make_svc_ctx(tuple(ctx), n_nodes=8).max_nodes == 8
    assert svc.make_svc_ctx(None) is None


def test_truncation_is_flagged_and_warned_as_the_reference():
    # the warning fires once a cache miss: start both caches empty, and
    # leave the reference's empty for its own test of the same spec
    svc.model._materialize.cache_clear()
    jsvc.model._materialize.cache_clear()
    try:
        with pytest.warns(UserWarning, match="max_jobs=8") as w:
            plan = svc.ServiceTrace(horizon=2000, rate=0.1, seed=0,
                                    max_jobs=8).plan()
        with pytest.warns(UserWarning) as wj:
            jsvc.ServiceTrace(horizon=2000, rate=0.1, seed=0,
                              max_jobs=8).plan()
    finally:
        jsvc.model._materialize.cache_clear()
    assert str(w[0].message) == str(wj[0].message)
    assert plan.truncated and plan.n_requests == 8


@pytest.mark.parametrize("make,match", [
    (lambda m: m.ServiceClass("x", dist="pareto"), "dist"),
    (lambda m: m.ServiceClass("x", nodes=0), "nodes"),
    (lambda m: m.AutoscalePolicy(up_threshold=2, down_threshold=2),
     "down_threshold < up_threshold"),
    (lambda m: m.AutoscalePolicy(up_threshold=5, down_threshold=1,
                                 min_nodes=4, max_nodes=2), "max_nodes"),
    (lambda m: m.ServiceTrace(horizon=100, classes=(
        m.ServiceClass("a"), m.ServiceClass("b", nodes=4)),
        autoscale=m.AutoscalePolicy(up_threshold=5, down_threshold=1,
                                    min_nodes=2)), "deadlock"),
    (lambda m: m.ServiceTrace(horizon=100, arrivals=((5, 0), (3, 0))),
     "sorted"),
    (lambda m: m.ServiceTrace(horizon=0), "horizon"),
    (lambda m: m.ServiceTrace(horizon=10, rate=0.0), "rate")])
def test_validation_as_the_reference(make, match):
    for mod in (svc, jsvc):
        with pytest.raises(ValueError, match=match):
            make(mod)


def test_clock_overflow_guard_as_the_reference():
    big = int(INF_TIME) // 2 - 1
    kw = dict(horizon=big, arrivals=((0, 0), (big - 1, 0)))
    with pytest.raises(ValueError, match="int32 clock"):
        svc.ServiceTrace(classes=(svc.ServiceClass(
            "x", mean_runtime=300_000_000),), **kw).plan()
    with pytest.raises(TypeError, match="svc ctx"):
        svc.make_svc_ctx((1, 2, 3))


def test_scenario_validation_as_the_reference():
    spec = _spec()
    with pytest.raises(ValueError, match="max_jobs"):
        rt.Scenario(trace=spec, total_nodes=16, capacity=512)
    with pytest.raises(ValueError, match="autoscal"):
        rt.Scenario(trace=spec, topology=rt.Topology.mesh2d(4, 4),
                    failures=rt.FailureModel(mtbf=500.0))
    # the engine refuses the same composition when called directly
    from repro_torch.core.engine import simulate
    jobs = rt.api.build_jobset(rt.Scenario(trace=spec, total_nodes=16),
                               device="cpu")
    with pytest.raises(ValueError, match="autoscaler"):
        simulate(jobs, "fcfs", 16, machine=rt.Topology.mesh2d(4, 4).build(
            "cpu"), failures=rt.FailureModel(mtbf=500.0), service=spec,
            device="cpu")
    with pytest.raises(ValueError, match="deadline rows"):
        simulate(rt.api.build_jobset(rt.Scenario(trace=spec,
                                                 total_nodes=16),
                                     capacity=300, device="cpu"),
                 "fcfs", 16, service=spec, device="cpu")


# ---------------------------------------------------------------------------
# the engine against run and run_ref
# ---------------------------------------------------------------------------

def test_tie_order_completions_then_capacity_then_arrivals():
    """One instant (t=50) carries a completion, a tick and an arrival: the
    tick reads the demand after the completion and before the arrival."""
    spec = rt.ServiceTrace(
        horizon=250, arrivals=((0, 0), (50, 0), (180, 0)),
        classes=(rt.ServiceClass("c", nodes=1, mean_runtime=50,
                                 slo_wait=100),), max_jobs=8,
        autoscale=rt.AutoscalePolicy(up_threshold=5, down_threshold=0,
                                     min_nodes=1, max_nodes=2, step=1,
                                     interval=50, max_ticks=4))
    res = _run(rt.Scenario(trace=spec, total_nodes=2))
    assert_matches_jax(res)
    out = res.to_np()
    np.testing.assert_array_equal(out["start"][:3], [0, 50, 180])
    np.testing.assert_array_equal(out["cap_time"], [50, 100, 150, 200])
    np.testing.assert_array_equal(out["cap_online"], [1, 1, 1, 1])
    assert bool(out["slo_met"][1])


def test_scale_up_reacts_to_queue_pressure():
    spec = rt.ServiceTrace(
        horizon=1200, rate=0.12, seed=3, max_jobs=256, classes=ONE_CLASS,
        autoscale=rt.AutoscalePolicy(up_threshold=3, down_threshold=0,
                                     min_nodes=1, max_nodes=8, step=2,
                                     interval=25, max_ticks=64))
    res = _run(rt.Scenario(trace=spec, total_nodes=8))
    assert_matches_jax(res)
    cap = res.to_np()["cap_online"]
    assert (np.diff(cap) > 0).any() and (np.diff(cap) < 0).any()


def test_service_none_carries_no_serving_columns():
    res = _run(rt.Scenario(trace={"submit": [0, 1], "runtime": [5, 5],
                                  "nodes": [1, 1]}, total_nodes=2))
    assert res.raw.svc is None and "slo_met" not in res.to_np()


@pytest.mark.parametrize("mode", ("scalar", "mesh2d"))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("autoscale", AUTOSCALES, ids=("on", "off"))
@pytest.mark.parametrize("classes", (ONE_CLASS, TWO_CLASS),
                         ids=("one_class", "two_class"))
@pytest.mark.parametrize("rate", RATES)
def test_engine_grid_matches_jax(rate, classes, autoscale, policy, mode):
    assert_matches_jax(_run(_scenario(mode, rate, classes, autoscale,
                                      policy)))


@pytest.mark.parametrize("policy,alloc", [
    ("backfill", "contiguous"), ("bestfit", "topo"), ("ljf", "spread"),
    ("backfill", "simple")])
def test_other_policies_and_strategies_on_a_machine(policy, alloc):
    scn = _scenario("mesh2d", 0.11, TWO_CLASS, SCALER, policy).with_(
        alloc=alloc)
    assert_matches_jax(_run(scn))


@pytest.mark.parametrize("policy", ("fcfs", "backfill", "preempt"))
def test_scalar_failures_compose_with_the_autoscaler(policy):
    scn = rt.Scenario(
        trace=_spec(autoscale=rt.AutoscalePolicy(
            up_threshold=5, down_threshold=1, min_nodes=4, step=1,
            interval=40, max_ticks=64)),
        total_nodes=16, policy=policy,
        failures=rt.FailureModel(mtbf=900.0, seed=2, mean_repair=60,
                                 horizon=1500, max_failures=16))
    res = _run(scn)
    assert_matches_jax(res)
    assert res["n_restarts"].sum() > 0 and len(res["cap_online"]) > 0


def test_machine_failures_without_an_autoscaler():
    """On a machine, failures compose with a service plan that carries no
    autoscaler (the one refused composition is an active scaler)."""
    scn = rt.Scenario(trace=_spec(autoscale=None),
                      topology=rt.Topology.mesh2d(4, 4), policy="fcfs",
                      failures=rt.FailureModel(mtbf=400.0, seed=2,
                                               mean_repair=60, horizon=1500,
                                               max_failures=32))
    assert_matches_jax(_run(scn))


def test_slo_summary_as_the_reference():
    s = _run(_scenario("scalar", 0.06, TWO_CLASS, SCALER, "fcfs")).summary()
    assert 0.0 <= s["slo_attainment"] <= 1.0
    assert 0.0 < s["slo_goodput"] <= 1.0
    for name in ("small", "big"):
        assert f"{name}_p99_wait" in s and f"{name}_miss_rate" in s


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16), rate=st.floats(0.01, 0.15),
       up=st.integers(2, 10), down=st.integers(0, 1),
       interval=st.integers(10, 80), policy=st.sampled_from(POLICIES),
       mode=st.sampled_from(("scalar", "mesh2d")))
def test_random_serving_matches_jax(seed, rate, up, down, interval, policy,
                                    mode):
    auto = rt.AutoscalePolicy(up_threshold=up, down_threshold=down,
                              min_nodes=4, max_nodes=16, step=2,
                              interval=interval, max_ticks=64)
    kw = dict(policy=policy)
    if mode == "mesh2d":
        kw.update(topology=rt.Topology.mesh2d(4, 4), alloc="simple")
    else:
        kw.update(total_nodes=16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = _run(rt.Scenario(trace=_spec(rate=rate, seed=seed,
                                           autoscale=auto), **kw))
        assert_matches_jax(res)
    cap = res.to_np()["cap_online"]
    if len(cap):
        assert cap.min() >= auto.min_nodes and cap.max() <= auto.max_nodes
