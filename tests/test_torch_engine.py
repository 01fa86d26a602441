"""Whole runs of the port (on the CPU) against the JAX engine.

``repro_torch.run(scn, device="cpu").to_np()`` must equal
``repro.api.run(scn).to_np()`` on every key of the scalar-counter schema,
and ``summary()`` must be equal too: exact equality, as both are integer
engines over the same arrays.
"""

import os

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro import api
from repro.core.jobs import make_jobset as jax_make_jobset
from repro_torch.core.jobs import make_jobset

POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
SCALAR_KEYS = ("submit", "nodes", "runtime", "start", "finish", "ready",
               "wait", "makespan", "n_events", "done", "valid")
TINY_SWF = os.path.join(os.path.dirname(__file__), "data", "tiny.swf")


def _assert_same_run(trace_port, trace_jax, **kw):
    port = rt.run(rt.Scenario(trace=trace_port, **kw), device="cpu")
    ref = api.run(api.Scenario(trace=trace_jax, **kw))
    a, b = port.to_np(), ref.to_np()
    assert set(b) == set(SCALAR_KEYS) and set(a) == set(b)
    for k in SCALAR_KEYS:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert port.summary() == ref.summary()
    assert port.matches(ref)
    return a


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind,total_nodes", [("das2", 400),
                                              ("sdsc_sp2", 128)])
def test_synthetic_matches_jax(kind, total_nodes, policy):
    spec = dict(n_jobs=300, seed=3, kind=kind, congest=4)
    _assert_same_run(rt.SyntheticTrace(**spec), api.SyntheticTrace(**spec),
                     total_nodes=total_nodes, policy=policy)


def test_policies_diverge():
    """The synthetic cases above are congested enough that the six policies
    give different schedules (otherwise they would test one policy)."""
    spec = rt.SyntheticTrace(n_jobs=300, seed=3, kind="sdsc_sp2", congest=4)
    starts = {p: rt.run(rt.Scenario(trace=spec, total_nodes=128, policy=p),
                        device="cpu")["start"].tobytes() for p in POLICIES}
    assert len(set(starts.values())) >= 5


@pytest.mark.parametrize("policy", POLICIES)
def test_swf_matches_jax(policy):
    _assert_same_run(rt.SwfTrace(TINY_SWF), api.SwfTrace(TINY_SWF),
                     total_nodes=64, policy=policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_array_trace_matches_jax(policy):
    rng = np.random.default_rng(11)
    n = 120
    trace = {"submit": rng.integers(0, 2000, n),
             "runtime": rng.integers(1, 300, n),
             "nodes": rng.integers(1, 40, n),
             "estimate": rng.integers(1, 600, n),
             "priority": rng.integers(0, 4, n)}
    _assert_same_run(rt.ArrayTrace(**trace), api.ArrayTrace(**trace),
                     total_nodes=32, policy=policy, capacity=128)


def test_high_priority_job_preempts_immediately():
    trace = {"submit": np.array([0, 10]), "runtime": np.array([100, 20]),
             "nodes": np.array([8, 8]), "estimate": np.array([100, 20]),
             "priority": np.array([5, 0])}
    out = _assert_same_run(rt.ArrayTrace(**trace), api.ArrayTrace(**trace),
                           total_nodes=8, policy="preempt")
    assert out["start"][1] == 10 and out["finish"][1] == 30
    assert out["finish"][0] == 120


def test_equal_priority_never_preempts():
    rng = np.random.default_rng(1)
    n = 40
    trace = {"submit": rng.integers(0, 100, n),
             "runtime": rng.integers(1, 50, n),
             "nodes": rng.integers(1, 9, n),
             "estimate": rng.integers(1, 100, n)}
    a = _assert_same_run(rt.ArrayTrace(**trace), api.ArrayTrace(**trace),
                         total_nodes=16, policy="preempt")
    b = rt.run(rt.Scenario(trace=trace, total_nodes=16, policy="fcfs"),
               device="cpu").to_np()
    np.testing.assert_array_equal(a["start"], b["start"])
    np.testing.assert_array_equal(a["finish"], b["finish"])


def test_victim_order_survives_priorities_near_inf_time():
    huge = int(2**29)
    trace = {"submit": np.array([0, 0, 0, 10]),
             "runtime": np.array([100, 100, 100, 20]),
             "nodes": np.array([2, 2, 2, 4]),
             "estimate": np.array([100, 100, 100, 20]),
             "priority": np.array([huge - 1, huge + 2, huge + 1, 0])}
    out = _assert_same_run(rt.ArrayTrace(**trace), api.ArrayTrace(**trace),
                           total_nodes=6, policy="preempt")
    assert out["finish"][0] == 100
    assert out["start"][3] == 10 and out["finish"][3] == 30
    assert out["finish"][1] > 100 and out["finish"][2] > 100


@pytest.mark.parametrize("seed", range(4))
def test_huge_priorities_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 24
    trace = {"submit": rng.integers(0, 120, n),
             "runtime": rng.integers(1, 60, n),
             "nodes": rng.integers(1, 7, n),
             "estimate": rng.integers(1, 120, n),
             "priority": rng.integers(2**28, 2**30 - 1, n)}
    _assert_same_run(rt.ArrayTrace(**trace), api.ArrayTrace(**trace),
                     total_nodes=12, policy="preempt")


@pytest.mark.parametrize("policy", ["fcfs", "backfill", "preempt"])
def test_max_events_cut_matches_jax(policy):
    spec = dict(n_jobs=200, seed=5, kind="sdsc_sp2", congest=4)
    out = _assert_same_run(rt.SyntheticTrace(**spec),
                           api.SyntheticTrace(**spec), total_nodes=128,
                           policy=policy, max_events=57)
    assert out["n_events"] == 57
    assert not out["done"][out["valid"]].all()


def test_make_jobset_matches_jax():
    rng = np.random.default_rng(2)
    n = 300
    args = (rng.integers(50, 5000, n), rng.integers(-3, 900, n),
            rng.integers(-2, 700, n))
    # ties in submit, clamped node requests, non-positive runtimes,
    # padding rows and negative priorities
    kw = dict(estimate=rng.integers(-1, 1200, n),
              priority=rng.integers(-5, 5, n), capacity=320,
              total_nodes=400)
    port = make_jobset(*args, device="cpu", **kw)
    ref = jax_make_jobset(*args, **kw)
    for f in ("submit", "runtime", "estimate", "nodes", "priority", "valid"):
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_make_jobset_rejects_what_jax_rejects():
    for kw in ({"capacity": 2}, {"runtime": [1, 2**30, 1]}):
        args = {"submit": [0, 1, 2], "runtime": [1, 2, 3], "nodes": [1, 1, 1]}
        args.update(kw)
        with pytest.raises(ValueError):
            make_jobset(**args, device="cpu")
        with pytest.raises(ValueError):
            jax_make_jobset(**args)


def test_run_defaults_to_cuda():
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=20), total_nodes=128)
    if torch.cuda.is_available():
        assert rt.run(scn).jobs.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.run(scn)
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.simulate(rt.api.build_jobset(scn, device="cpu"), "fcfs", 128)


@pytest.mark.parametrize("field,value", [
    ("malleable", object()), ("multicluster", object())])
def test_unported_features_raise(field, value):
    """Both fields, refused before their slices, are ported now.  A
    ``malleable`` value that is no ``MalleableModel`` raises as the
    reference's does (``test_malleable_field_runs`` runs a model); a
    ``multicluster`` value with a single trace raises as the reference's
    does (``tests/test_torch_multicluster.py`` runs multicluster
    scenarios)."""
    for mod in (rt, api):
        if field == "malleable":
            with pytest.raises(TypeError, match="MalleableModel"):
                mod.Scenario(trace=mod.SyntheticTrace(n_jobs=5),
                             total_nodes=8, malleable=value)
        else:
            with pytest.raises(ValueError,
                               match="one trace spec per cluster"):
                mod.Scenario(trace=mod.SyntheticTrace(n_jobs=5),
                             total_nodes=8, multicluster=value)


def test_malleable_field_runs():
    """``malleable``, refused before the malleable slice, now runs and
    equals the JAX engine column by column, the ``mal_*`` ones included."""
    mal = dict(curve="power", param=0.6, max_width=8, mode="elastic",
               interval=40, max_ticks=32, shrink_threshold=6,
               grow_threshold=1, step=2)
    port = rt.run(rt.Scenario(trace=rt.SyntheticTrace(n_jobs=30, seed=2),
                              total_nodes=8, policy="backfill",
                              malleable=rt.MalleableModel(**mal)),
                  device="cpu")
    ref = api.run(api.Scenario(trace=api.SyntheticTrace(n_jobs=30, seed=2),
                               total_nodes=8, policy="backfill",
                               malleable=api.MalleableModel(**mal)))
    a, b = port.to_np(), ref.to_np()
    assert set(a) == set(b) and "mal_width" in a
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("field", ("failures", "failures_on_a_machine"))
def test_failure_field_runs(field):
    """``failures``, refused before the reliability slice, now runs and
    equals the JAX engine, in scalar mode and on a machine; a value that
    is no ``FailureModel`` is refused as the reference refuses it."""
    fm = dict(mtbf=400.0, seed=3, mean_repair=40, horizon=3000,
              max_failures=32)
    kw, jax_kw = dict(total_nodes=8), dict(total_nodes=8)
    if field == "failures_on_a_machine":
        kw = dict(topology=rt.Topology.linear(8, group_size=4),
                  alloc="contiguous")
        jax_kw = dict(topology=api.Topology("linear", (8, 4)),
                      alloc="contiguous")
    port = rt.run(rt.Scenario(trace=rt.SyntheticTrace(n_jobs=30, seed=2),
                              policy="backfill",
                              failures=rt.FailureModel(**fm), **kw),
                  device="cpu")
    ref = api.run(api.Scenario(trace=api.SyntheticTrace(n_jobs=30, seed=2),
                               policy="backfill",
                               failures=api.FailureModel(**fm), **jax_kw))
    a, b = port.to_np(), ref.to_np()
    assert set(a) == set(b) and "n_restarts" in a
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(TypeError, match="FailureModel"):
        rt.Scenario(trace=rt.SyntheticTrace(n_jobs=5), total_nodes=8,
                    failures=object())


@pytest.mark.parametrize("field,value", [
    ("topology", rt.Topology.linear(8, group_size=4)), ("alloc", "topo")])
def test_allocation_fields_run(field, value):
    """``topology`` and ``alloc``, refused before the allocation slice, now
    run and equal the JAX engine (``alloc`` needs a topology)."""
    kw = {field: value}
    if field == "alloc":
        kw["topology"] = rt.Topology.linear(8, group_size=4)
    jax_kw = {k: (api.Topology(v.kind, v.shape)
                  if isinstance(v, rt.Topology) else v)
              for k, v in kw.items()}
    port = rt.run(rt.Scenario(trace=rt.SyntheticTrace(n_jobs=30, seed=2),
                              total_nodes=8, policy="backfill", **kw),
                  device="cpu")
    ref = api.run(api.Scenario(trace=api.SyntheticTrace(n_jobs=30, seed=2),
                               total_nodes=8, policy="backfill", **jax_kw))
    a, b = port.to_np(), ref.to_np()
    assert set(a) == set(b) and "ev_lfb" in a
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dependencies_raise():
    """Dependency edges are carried (ROADMAP Queue 1 item 3): valid edges
    run as the JAX engine runs them, and bad ones raise as there."""
    trace = {"submit": [0, 0], "runtime": [1, 1], "nodes": [1, 1],
             "deps": [(1, 0)]}
    a = rt.run(rt.Scenario(trace=dict(trace), total_nodes=4),
               device="cpu").to_np()
    b = api.run(api.Scenario(trace=dict(trace), total_nodes=4)).to_np()
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["ready"][1] == a["finish"][0] == 1
    with pytest.raises(ValueError, match="cycle"):
        rt.run(rt.Scenario(trace=dict(trace, deps=[(1, 0), (0, 1)]),
                           total_nodes=4), device="cpu")
