"""Workflow DAGs on the cluster: the port against the JAX engine and the
host oracle, on the CPU.

- the differential grid of ``tests/test_workflow_cluster.py``: chain,
  montage, galactic and sipht DAGs x the six policies x scalar mode,
  mesh2d+contiguous and dragonfly+topo, all at capacity 64;
  ``repro_torch.run(...).to_np()`` equals ``repro.api.run(...).to_np()``
  key by key (``ready``, ``wait``, the fingerprints and the ``ev_*`` log
  included) and, in scalar mode, ``repro.api.run_ref``'s start, finish,
  ready and wait;
- dependencies with preemption, critical-path priorities through preempt,
  wait = start - ready, and a hypothesis property over random layered DAGs;
- sweeps: a policy x alloc grid over one DAG and a seed axis with ragged
  edge lists each run as one bucket, as the JAX sweep does, every member
  equal to JAX's;
- ``WorkflowTrace``'s spec hygiene, as the reference's.
"""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro_torch as rt
from repro import api
from repro.core import engine as jengine
from repro.core.jobs import POLICY_IDS
from repro.core.jobs import make_jobset as jax_make_jobset
from repro_torch.api import as_trace_spec
from repro_torch.core import engine
from repro_torch.core.jobs import make_jobset
from repro_torch.traces.workflows import random_layered, workflow_to_trace

POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
CAP = 64
DAGS = {
    "chain": dict(kind="chain", params=(("n", 10), ("exec_time", 40),
                                        ("cpu", 3))),
    "montage": dict(kind="montage", params=(("width", 8),)),
    "galactic": dict(kind="galactic", params=(("tiles", 2), ("width", 5))),
    "sipht": dict(kind="sipht", params=(("width", 12),)),
}
CONFIGS = {
    "scalar": (None, dict(total_nodes=8)),
    "mesh2d_contiguous": (("mesh2d", (8, 8)), dict(alloc="contiguous")),
    "dragonfly_topo": (("dragonfly", (8, 8)), dict(alloc="topo")),
}


def scenarios(trace: dict, config: str, **kw):
    """The port's and the JAX package's scenario of one case."""
    topo, extra = CONFIGS[config]
    out = []
    for mod in (rt, api):
        tr = (mod.WorkflowTrace(**trace) if "kind" in trace else dict(trace))
        out.append(mod.Scenario(
            trace=tr, topology=None if topo is None else mod.Topology(*topo),
            **extra, **kw))
    return out


def assert_same(a, b):
    assert set(a) == set(b)
    for k in b:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dag", sorted(DAGS))
def test_run_matches_jax_on_workflow_grid(dag, policy, config):
    port_scn, jax_scn = scenarios(DAGS[dag], config, policy=policy,
                                  capacity=CAP)
    port = rt.run(port_scn, device="cpu")
    out = port.to_np()
    assert_same(out, api.run(jax_scn).to_np())
    n = int(out["valid"].sum())
    assert out["done"][:n].all()
    if config == "scalar":
        ref = api.run_ref(jax_scn)
        assert port.matches(ref)
        for k in ("ready", "wait"):
            np.testing.assert_array_equal(out[k][:n], ref[k], err_msg=k)


def test_wait_is_start_minus_ready_not_submit():
    port_scn, _ = scenarios(DAGS["montage"], "scalar", policy="fcfs",
                            capacity=CAP)
    res = rt.run(port_scn, device="cpu")
    out = res.to_np()
    v = out["valid"]
    assert (out["submit"][v] == 0).all()
    assert (out["ready"][v] > 0).any()
    np.testing.assert_array_equal(out["wait"][v],
                                  out["start"][v] - out["ready"][v])
    assert (out["wait"][v] >= 0).all()
    w = out["wait"][v & out["done"]].astype(float)
    assert res.summary()["avg_wait"] == pytest.approx(w.mean())


def test_cpath_priority_flows_through_preempt():
    trace = dict(DAGS["galactic"], priority="cpath")
    port_scn, jax_scn = scenarios(trace, "scalar", policy="preempt",
                                  capacity=CAP)
    assert "priority" in port_scn.trace.materialize()
    np.testing.assert_array_equal(port_scn.trace.materialize()["priority"],
                                  jax_scn.trace.materialize()["priority"])
    port = rt.run(port_scn, device="cpu")
    assert_same(port.to_np(), api.run(jax_scn).to_np())
    assert port.matches(api.run_ref(jax_scn))


def test_preempted_dependency_does_not_release_dependents():
    """A (low priority) is preempted by B at t=10 and returns to WAITING,
    not DONE: C, which depends on A, releases at A's true finish (120)."""
    trace = {"submit": np.array([0, 10, 0]),
             "runtime": np.array([100, 20, 10]),
             "nodes": np.array([4, 4, 2]),
             "estimate": np.array([100, 20, 10]),
             "priority": np.array([5, 0, 5]),
             "deps": [(2, 0)]}
    port_scn, jax_scn = scenarios(trace, "scalar", policy="preempt")
    port_scn = port_scn.with_(total_nodes=4)
    jax_scn = jax_scn.with_(total_nodes=4)
    out = rt.run(port_scn, device="cpu").to_np()
    a, c, b = 0, 1, 2          # rows in (submit, id) order
    assert out["start"][b] == 10
    assert out["finish"][a] == 120
    assert out["ready"][c] == 120
    assert out["start"][c] >= out["finish"][a]
    assert_same(out, api.run(jax_scn).to_np())
    ref = api.run_ref(jax_scn)
    np.testing.assert_array_equal(out["ready"][:3], ref["ready"])


def _dag(seed: int, layers: int):
    return workflow_to_trace(random_layered(30, layers, p_edge=0.2,
                                            seed=seed))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), layers=st.integers(2, 6),
       policy=st.sampled_from(POLICIES), total_nodes=st.sampled_from([8, 16]))
def test_random_layered_dags_match_jax(seed, layers, policy, total_nodes):
    trace = _dag(seed, layers)
    args = (trace["submit"], trace["runtime"], trace["nodes"],
            trace["estimate"])
    jobs = make_jobset(*args, deps=trace["deps"], total_nodes=total_nodes,
                       device="cpu")
    res = engine.simulate(jobs, policy, total_nodes, device="cpu")
    jres = jengine.simulate(
        jax_make_jobset(*args, deps=trace["deps"], total_nodes=total_nodes),
        POLICY_IDS[policy], total_nodes)
    for f in ("start", "finish", "ready", "wait", "done"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(jres, f)), f)
    assert res.n_events == int(jres.n_events)
    # no job starts before every dependency finished
    deps = jobs.deps.numpy()
    start, finish = res.start.numpy(), res.finish.numpy()
    for i, j in zip(*np.nonzero(deps)):
        assert start[i] >= finish[j]


def test_sweep_policy_alloc_grid_over_a_dag_is_one_bucket():
    axes = {"policy": ("fcfs", "sjf", "backfill"),
            "alloc": ("simple", "contiguous")}
    port_scn, jax_scn = scenarios(DAGS["galactic"], "mesh2d_contiguous",
                                  policy="fcfs", capacity=CAP)
    port_scn, jax_scn = port_scn.with_(alloc=None), jax_scn.with_(alloc=None)
    grid = rt.sweep(port_scn, axes=axes, device="cpu")
    want = api.sweep(jax_scn, axes=axes)
    assert grid.n_compiles == want.n_compiles == 1
    assert grid.points == want.points
    for (point, r), w in zip(grid, want.results):
        assert_same(r.to_np(), w.to_np())
        assert r.matches(api.run_ref(w.scenario), node_maps=True), point


def test_sweep_seed_axis_with_ragged_edges_is_one_bucket():
    trace = dict(kind="random", params=(("n_tasks", 24), ("n_layers", 4)))
    port_scn, jax_scn = scenarios(trace, "scalar", policy="fcfs")
    axes = {"trace.seed": (0, 1, 2), "policy": ("fcfs", "bestfit")}
    grid = rt.sweep(port_scn, axes=axes, device="cpu")
    want = api.sweep(jax_scn, axes=axes)
    assert grid.n_compiles == want.n_compiles == 1
    assert len({r.jobs.edge_capacity for r in grid.results}) == 1
    edges = {len(r.scenario.trace.materialize()["deps"])
             for r in grid.results}
    assert len(edges) > 1                      # the seeds' edge counts differ
    for r, w in zip(grid.results, want.results):
        assert_same(r.to_np(), w.to_np())
    a = grid.get(**{"trace.seed": 0}, policy="fcfs")
    b = grid.get(**{"trace.seed": 1}, policy="fcfs")
    assert not np.array_equal(a["runtime"], b["runtime"])


def test_workflow_trace_spec_hygiene():
    spec = rt.WorkflowTrace(kind="montage", params=(("width", 8),))
    assert spec.static_key() == rt.WorkflowTrace(
        kind="montage", seed=99, params=(("width", 8),)).static_key()
    assert spec.static_key() == api.WorkflowTrace(
        kind="montage", params=(("width", 8),)).static_key()
    assert spec.n_rows == 29
    a = spec.materialize()
    b = api.WorkflowTrace(kind="montage", params=(("width", 8),)).materialize()
    assert set(a) == set(b) and a["deps"] == b["deps"]
    for k in ("submit", "runtime", "estimate", "nodes"):
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="unknown workflow kind"):
        rt.WorkflowTrace(kind="pegasus").materialize()
    with pytest.raises(ValueError, match="unknown workflow priority"):
        rt.WorkflowTrace(priority="hef").materialize()
    scn = rt.Scenario(trace=spec, topology=rt.Topology.mesh2d(4, 4),
                      policy="fcfs")
    assert isinstance(scn.with_(**{"trace.seed": 5}).trace, rt.WorkflowTrace)
    assert as_trace_spec(spec) is spec


def test_unported_traces_name_what_is_left():
    """Workflow (item 3), service (item 5) and injected what-if traces
    (item 8) and per-cluster trace tuples (item 6) are carried now; what
    is not a trace spec is refused with the reference's TypeError."""
    with pytest.raises(TypeError) as err:
        as_trace_spec(42)
    with pytest.raises(TypeError) as want:
        api.as_trace_spec(42)
    assert str(err.value) == str(want.value)
    spec = rt.ServiceTrace(horizon=100, rate=0.1)
    assert as_trace_spec(spec) is spec
    spec = rt.InjectedTrace(base=rt.SyntheticTrace(n_jobs=5),
                            jobs=((0, 10, 1),))
    assert as_trace_spec(spec) is spec
