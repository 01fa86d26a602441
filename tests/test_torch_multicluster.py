"""Multicluster conservative windows of the PyTorch port against the JAX
package, on the CPU.

- ``tests/test_parallel.py``'s four multicluster tests, each run on both
  engines and the results equal key by key: no migration equals the
  independent runs, window invariance without migration, migration
  conserves jobs, and migration helps an imbalanced load;
- ``tests/test_multicluster_sharded.py``'s configuration (C 4, J 120,
  backfill, window 4,000, ``max_export`` 4) equal to JAX's vmapped run
  field by field, and a ``mesh=`` that is no ``DeviceMesh`` refused (the
  mesh runs are tests/test_torch_mesh.py's);
- ``tests/test_workflow_cluster.py``'s multicluster DAG tests (pinned
  edges keep DAG clusters independent; a DAG cluster beside a plain one);
- ``tests/test_api.py``'s multicluster tests (a static sweep axis, the
  result schema, the single-trace refusal) and the reference's other
  refusals, with its messages and types;
- a hypothesis property on ``_export_jobs``/``_import_jobs`` (tied submits,
  edges, random states) against the reference's vmapped functions, and on
  the imbalance decision with tied loads; a queue load that wraps int32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro_torch as rt
from repro import api
from repro.core import parallel as jpar
from repro.core.jobs import SimState as JaxSimState
from repro.core.jobs import make_jobset as jax_make_jobset
from repro.traces import das2_like
from repro_torch.core import parallel
from repro_torch.core.jobs import (
    DONE, PENDING, POLICY_IDS, RUNNING, WAITING, EnsembleState, make_jobset,
)

CAP = 64


def stacks(traces, nodes, capacity, deps=None):
    """The port's (on the CPU) and the JAX package's stacked tables."""
    deps = deps or [None] * len(traces)
    out = []
    for mk, stack, kw in ((make_jobset, parallel.stack_jobsets,
                           {"device": "cpu"}),
                          (jax_make_jobset, jpar.stack_jobsets, {})):
        out.append(stack([mk(t["submit"], t["runtime"], t["nodes"],
                             t.get("estimate"), deps=d, capacity=capacity,
                             total_nodes=nodes, **kw)
                          for t, d in zip(traces, deps)]))
    return out


def both(traces, policy, nodes, capacity, **kw):
    """``multicluster_result_np`` of both engines' runs, after checking
    that they are equal key by key; returns the port's."""
    pc, jc = stacks(traces, nodes, capacity)
    C = len(traces)
    a = parallel.simulate_multicluster(pc, policy, [nodes] * C,
                                       device="cpu", **kw)
    b = jpar.simulate_multicluster(jc, POLICY_IDS[policy], [nodes] * C,
                                   **kw)
    x, y = parallel.multicluster_result_np(a), jpar.multicluster_result_np(b)
    assert set(x) == set(y)
    assert [k for k in y if not np.array_equal(np.asarray(x[k]),
                                               np.asarray(y[k]))] == []
    assert a.state.n_events == np.asarray(b.state.n_events).tolist()
    return x, a, b


def das2_sets(C, J, seed0=30):
    traces = [das2_like(J, seed=seed0 + s) for s in range(C)]
    horizon = int(max(t["submit"].max() for t in traces) + 50_000)
    return traces, horizon


# ---------------------------------------------------------------------------
# tests/test_parallel.py's multicluster tests
# ---------------------------------------------------------------------------


def test_no_migration_equals_independent():
    traces, horizon = das2_sets(4, 120)
    out, mc, _ = both(traces, "backfill", 128, 120 + 64, window=4000,
                      horizon=horizon, migrate=False)
    assert not out["saturated"]
    for s, t in enumerate(traces):
        solo = rt.simulate(make_jobset(t["submit"], t["runtime"], t["nodes"],
                                       t["estimate"], capacity=184,
                                       total_nodes=128, device="cpu"),
                           "backfill", 128, device="cpu")
        assert torch.equal(mc.state.start[s], solo.start)


def test_window_invariance_without_migration():
    traces, horizon = das2_sets(2, 100)
    starts = [both(traces, "fcfs", 128, 164, window=w, horizon=horizon,
                   migrate=False)[0]["start"] for w in (1000, 7000, 50_000)]
    np.testing.assert_array_equal(starts[0], starts[1])
    np.testing.assert_array_equal(starts[0], starts[2])


def test_migration_conserves_jobs():
    traces, horizon = das2_sets(4, 150)
    out = both(traces, "backfill", 64, 214, window=5000, horizon=horizon,
               migrate=True, max_export=4)[0]
    assert out["dropped"] == 0 and not out["saturated"]
    assert out["valid"].sum() == out["done"].sum() == 4 * 150
    v = out["valid"]
    assert (out["start"][v] >= out["submit"][v]).all()


def test_migration_helps_imbalanced_load():
    hot = das2_like(200, seed=77)
    hot["submit"] = hot["submit"] // 4
    cold = {k: v[:20] for k, v in das2_like(20, seed=78).items()}
    kw = dict(window=2000, horizon=int(hot["submit"].max() + 100_000),
              max_export=8, load_imbalance_threshold=1.2)
    a = both([hot, cold], "fcfs", 64, 280, migrate=False, **kw)[0]
    b = both([hot, cold], "fcfs", 64, 280, migrate=True, **kw)[0]
    assert b["migrated"] > 0
    assert b["makespan"] <= a["makespan"]


def test_sharded_configuration_and_mesh_refused():
    """tests/test_multicluster_sharded.py's grid, on one device: every
    state field equals the reference's vmapped run."""
    traces = [das2_like(120, seed=50 + s) for s in range(4)]
    horizon = int(max(t["submit"].max() for t in traces) + 50_000)
    kw = dict(window=4000, horizon=horizon, migrate=True, max_export=4)
    out, a, b = both(traces, "backfill", 96, 152, **kw)
    for f in ("jstate", "start", "finish", "rsv_finish", "remaining"):
        np.testing.assert_array_equal(getattr(a.state, f).numpy(),
                                      np.asarray(getattr(b.state, f)),
                                      err_msg=f)
    for f in ("submit", "runtime", "estimate", "nodes", "priority", "valid"):
        np.testing.assert_array_equal(getattr(a.jobs, f).numpy(),
                                      np.asarray(getattr(b.jobs, f)),
                                      err_msg=f)
    assert a.migrated.tolist() == np.asarray(b.migrated).tolist()
    assert out["dropped"] == 0 and out["done"].sum() == 480
    pc, _ = stacks(traces, 96, 152)
    with pytest.raises(TypeError, match="DeviceMesh"):
        parallel.simulate_multicluster(pc, "backfill", [96] * 4,
                                       mesh=object(), device="cpu", **kw)


# ---------------------------------------------------------------------------
# DAG clusters (tests/test_workflow_cluster.py)
# ---------------------------------------------------------------------------


def scenario(mod, traces, **kw):
    return mod.Scenario(trace=traces, **kw)


def test_workflow_clusters_stay_independent():
    """Rows with edges are pinned to their cluster: two DAG clusters with
    migration equal the run without it and each DAG's solo run."""
    specs = {m: tuple(m.WorkflowTrace(kind="montage", seed=s,
                                      params=(("width", 6),))
                      for s in (0, 1)) for m in (rt, api)}
    base = dict(total_nodes=8, policy="fcfs", capacity=CAP)
    mig = rt.run(scenario(rt, specs[rt], multicluster=rt.Multicluster(
        window=50), **base), device="cpu").to_np()
    ref = api.run(scenario(api, specs[api], multicluster=api.Multicluster(
        window=50), **base)).to_np()
    assert [k for k in ref if not np.array_equal(np.asarray(mig[k]),
                                                 np.asarray(ref[k]))] == []
    no_mig = rt.run(scenario(rt, specs[rt], multicluster=rt.Multicluster(
        window=50, migrate=False), **base), device="cpu").to_np()
    np.testing.assert_array_equal(mig["start"], no_mig["start"])
    assert mig["migrated"] == 0
    for c, spec in enumerate(specs[rt]):
        single = rt.run(rt.Scenario(trace=spec, **base),
                        device="cpu").to_np()
        sl = slice(c * CAP, (c + 1) * CAP)
        np.testing.assert_array_equal(mig["start"][sl], single["start"])
        np.testing.assert_array_equal(mig["ready"][sl], single["ready"])


def test_mixed_workflow_and_plain_clusters():
    """A DAG cluster beside a dependency-free one (pad edges only): only
    the dependency-free jobs may migrate; equal to the reference."""
    outs = []
    for m in (rt, api):
        scn = m.Scenario(
            trace=(m.WorkflowTrace(kind="sipht", params=(("width", 8),)),
                   m.SyntheticTrace(n_jobs=40, seed=3, kind="das2",
                                    congest=20)),
            total_nodes=16, policy="fcfs", capacity=CAP,
            multicluster=m.Multicluster(window=100))
        outs.append((rt.run(scn, device="cpu") if m is rt
                     else api.run(scn)).to_np())
    out, ref = outs
    assert [k for k in ref if not np.array_equal(np.asarray(out[k]),
                                                 np.asarray(ref[k]))] == []
    assert out["valid"].sum() == 18 + 40
    assert out["done"][out["valid"]].all() and out["dropped"] == 0


# ---------------------------------------------------------------------------
# the API (tests/test_api.py) and the reference's refusals
# ---------------------------------------------------------------------------


def test_sweep_multicluster_static_axis():
    grids = []
    for m in (rt, api):
        scn = m.Scenario(
            trace=tuple(m.SyntheticTrace(n_jobs=40, seed=s, kind="das2")
                        for s in range(2)),
            total_nodes=64, policy="backfill",
            multicluster=m.Multicluster(window=4000, migrate=False))
        axes = {"multicluster.window": (2000, 8000)}
        grids.append(rt.sweep(scn, axes, device="cpu") if m is rt
                     else api.sweep(scn, axes))
    grid, ref = grids
    assert grid.n_compiles == ref.n_compiles == 2
    for (_, r), (_, q) in zip(grid, ref):
        assert r.backend == "multicluster"
        for k in ("start", "finish", "valid", "done"):
            np.testing.assert_array_equal(r[k], q[k])
    a, b = (r.to_np() for _, r in grid)
    np.testing.assert_array_equal(a["start"], b["start"])
    assert a["valid"].sum() == 80


def test_result_schema_and_summary():
    outs = []
    for m in (rt, api):
        scn = m.Scenario(trace=(m.SyntheticTrace(n_jobs=30, seed=0),
                                m.SyntheticTrace(n_jobs=30, seed=1)),
                         total_nodes=(128, 64), policy="fcfs",
                         multicluster=m.Multicluster(window=5000))
        outs.append(rt.run(scn, device="cpu") if m is rt else api.run(scn))
    res, ref = outs
    assert {"submit", "runtime", "nodes", "start", "finish", "wait",
            "valid", "done", "makespan", "migrated", "dropped",
            "saturated"} <= set(res.to_np())
    assert res.summary() == ref.summary()


def test_scenario_tuples_and_with():
    scn = rt.Scenario(trace=[rt.SyntheticTrace(n_jobs=10, seed=s)
                             for s in range(3)], total_nodes=8,
                      multicluster=rt.Multicluster(window=100))
    assert isinstance(scn.trace, tuple)
    assert scn.nodes_per_cluster() == (8, 8, 8)
    moved = scn.with_(**{"trace.n_jobs": 20})
    assert [t.n_jobs for t in moved.trace_specs()] == [20] * 3
    with pytest.raises(ValueError, match="3 clusters"):
        scn.with_(total_nodes=(8, 8)).nodes_per_cluster()


def _refusal_kwargs(m):
    t = m.SyntheticTrace(n_jobs=10)
    mc = m.Multicluster(window=100)
    return {
        "single": (ValueError, "one trace spec per cluster",
                   dict(trace=t, total_nodes=8, multicluster=mc)),
        "failures": (ValueError, "failures are not supported",
                     dict(trace=(t, t), total_nodes=8, multicluster=mc,
                          failures=m.FailureModel(mtbf=1e4))),
        "malleable": (ValueError, "malleable jobs are not supported",
                      dict(trace=(t, t), total_nodes=8, multicluster=mc,
                           malleable=m.MalleableModel())),
        "service": (ValueError, "ServiceTrace is not supported",
                    dict(trace=(t, m.ServiceTrace(horizon=100, rate=0.1)),
                         total_nodes=8, multicluster=mc)),
    }


@pytest.mark.parametrize("case", ("single", "failures", "malleable",
                                  "service"))
def test_refusals_match_the_reference(case):
    for m in (rt, api):
        err, msg, kw = _refusal_kwargs(m)[case]
        with pytest.raises(err, match=msg):
            m.Scenario(**kw)


def test_run_refusals_match_the_reference():
    for m in (rt, api):
        scn = m.Scenario(trace=(m.SyntheticTrace(n_jobs=10),) * 2,
                         topology=m.Topology.mesh2d(2, 4),
                         multicluster=m.Multicluster(window=100))
        run = (lambda s: rt.run(s, device="cpu")) if m is rt else api.run
        with pytest.raises(ValueError, match="scalar-counter clusters"):
            run(scn)
        with pytest.raises(ValueError, match="no multicluster mode"):
            m.run_ref(scn)


# ---------------------------------------------------------------------------
# the exchange, piece by piece
# ---------------------------------------------------------------------------


def random_stacks(seed: int, C: int = 3, J: int = 12):
    """Stacked tables with tied submits and a few edges, and random
    states: the port's ``(jobs, state)`` and the reference's."""
    rng = np.random.default_rng(seed)
    traces, deps = [], []
    for _ in range(C):
        n = int(rng.integers(4, J + 1))
        traces.append({"submit": rng.integers(0, 4, n),
                       "runtime": rng.integers(1, 50, n),
                       "nodes": rng.integers(1, 6, n),
                       "estimate": rng.integers(1, 80, n)})
        deps.append([(int(i), int(rng.integers(0, i)))
                     for i in range(1, n) if rng.random() < 0.25] or None)
    deps[0] = deps[0] or [(1, 0)]   # the stack carries edges
    pc, jc = stacks(traces, 8, J, deps)
    jstate = rng.choice([PENDING, WAITING, RUNNING, DONE], (C, J)).astype(
        np.int32)
    jstate[~np.asarray(jc.valid)] = DONE
    unmet = rng.integers(0, 2, (C, J)).astype(np.int32)
    ps = EnsembleState.init(pc, [8] * C)
    ps.jstate.copy_(torch.from_numpy(jstate))
    ps.n_unmet.copy_(torch.from_numpy(unmet))
    js = jax.vmap(JaxSimState.init, in_axes=(0, None))(jc, 8)
    js = js.__class__(**{**js.__dict__, "jstate": jnp.asarray(jstate),
                         "n_unmet": jnp.asarray(unmet)})
    return pc, ps, jc, js, rng


def assert_same(pj, ps, jj, js):
    for f in ("submit", "runtime", "estimate", "nodes", "priority", "valid",
              "dep_dst", "dep_src"):
        np.testing.assert_array_equal(getattr(pj, f).numpy(),
                                      np.asarray(getattr(jj, f)), err_msg=f)
    for f in ("jstate", "start", "finish", "rsv_finish", "remaining",
              "n_unmet"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


@given(seed=st.integers(0, 10_000), max_export=st.integers(1, 6),
       dest=st.integers(0, 2))
@settings(max_examples=25, deadline=None)
def test_export_import_property(seed, max_export, dest):
    pc, ps, jc, js, rng = random_stacks(seed)
    enable = rng.random(3) < 0.7
    enable[dest] = False
    t_hi, latency = 1000, 700
    pj, pkt = parallel._export_jobs(pc, ps, t_hi, latency, max_export,
                                    torch.from_numpy(enable))
    jj, js, jpkt = jax.vmap(lambda j, s, en: jpar._export_jobs(
        j, s, t_hi, jnp.int32(latency), max_export, en))(jc, js, enable)
    for k in pkt:
        np.testing.assert_array_equal(pkt[k].numpy(), np.asarray(jpkt[k]),
                                      err_msg=k)
    assert_same(pj, ps, jj, js)
    flat = {k: v.reshape(-1) for k, v in pkt.items()}
    mine = torch.arange(3)[:, None] == dest
    flat["ok"] = flat["ok"][None, :] & mine
    pj, dropped = parallel._import_jobs(pj, ps, flat)
    gpkt = {k: np.asarray(v).reshape(-1) for k, v in jpkt.items()}

    def imp(j, s, gid):
        f = dict(gpkt)
        f["ok"] = gpkt["ok"] & (gid == dest)
        return jpar._import_jobs(j, s, f)

    jj, js, jdropped = jax.vmap(imp)(jj, js, jnp.arange(3))
    assert_same(pj, ps, jj, js)
    assert dropped.tolist() == np.asarray(jdropped).tolist()


@given(loads=st.lists(st.integers(0, 6), min_size=2, max_size=6),
       threshold=st.sampled_from([1.0, 1.2, 1.5]))
@settings(max_examples=60, deadline=None)
def test_imbalance_decision_with_tied_loads(loads, threshold):
    """The least loaded cluster is the first on ties, and the float32
    over-test is the reference's."""
    dest, over = parallel._imbalance(loads, threshold)
    ld = jnp.asarray(loads, jnp.int32)
    mean = jnp.mean(ld.astype(jnp.float32))
    jdest = int(jnp.argmin(ld))
    jover = ((ld.astype(jnp.float32) > threshold * mean)
             & (jnp.arange(len(loads)) != jdest) & (ld[jdest] < ld))
    assert dest == jdest
    assert over == np.asarray(jover).tolist()


def test_queue_load_wraps_as_the_reference():
    """Node-seconds beyond int32 wrap in both engines alike."""
    n = 600
    trace = {"submit": np.zeros(n, np.int64),
             "runtime": np.full(n, 100_000), "nodes": np.full(n, 4096),
             "estimate": np.full(n, 100_000)}
    pc, jc = stacks([trace, trace], 4096, n)
    ps = EnsembleState.init(pc, [4096, 4096])
    js = jax.vmap(JaxSimState.init, in_axes=(0, None))(jc, 4096)
    got = parallel._queue_load(pc, ps)
    want = jax.vmap(jpar._queue_load)(jc, js)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()
    assert 4096 * (1 << 16) * n > 2 ** 31   # the sum did wrap
