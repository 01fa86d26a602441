"""The dependency axis of the port's job table and the blocking prefix pass,
against the JAX package, on the CPU.

- representation: ``make_jobset``'s padded ``dep_dst``/``dep_src`` equal the
  JAX package's array for array (built by a sort of the permuted pairs in
  place of a dense matrix), the unmet counters start at the in-degrees,
  the release (a scatter-add over the edge list) counts what the JAX
  engine's ``dep_csr`` release counts for any completions, and the refusals
  (cycles, self-dependencies, pairs out of range, a dense matrix of the
  wrong shape, a short ``edge_capacity``) are the reference's;
- the prefix pass: FCFS, SJF and LJF on tables with edges take it in
  scalar mode and under ``simple``/``spread`` (``_fast_order``'s table),
  make no selection, and equal the per-start loop and the JAX engine;
- elision: ``deps=None``, ``[]`` and an all-False matrix give one schedule;
- stacking: ``stack_jobsets`` pads ragged edge lists (and a table without
  edges) as the reference does, and every ensemble member equals its solo
  run, in scalar mode and on a machine.
"""

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro_torch as rt
from repro import api
from repro.core import engine as jengine
from repro.core import jobs as jjobs
from repro.core import parallel as jparallel
from repro_torch.core import engine
from repro_torch.core import jobs as tjobs
from repro_torch.core import parallel as tparallel
from repro_torch.traces.workflows import (
    galactic_like, montage_like, random_layered, workflow_to_trace,
)

POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
BLOCKING = ("fcfs", "sjf", "ljf")


def both(trace, **kw):
    """The port's (CPU) and the JAX package's job table of one trace."""
    args = (trace["submit"], trace["runtime"], trace["nodes"],
            trace.get("estimate"))
    return (tjobs.make_jobset(*args, deps=trace.get("deps"), device="cpu",
                              **kw),
            jjobs.make_jobset(*args, deps=trace.get("deps"), **kw))


def _fields(res, names=("start", "finish", "ready", "wait", "done")):
    return {f: np.asarray(getattr(res, f)) for f in names}


# ---------------------------------------------------------------------------
# representation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_edge_arrays_equal_jax(seed):
    trace = workflow_to_trace(random_layered(40, 5, p_edge=0.2, seed=seed))
    rng = np.random.default_rng(seed)
    trace["submit"] = rng.integers(0, 50, 40)         # a real permutation
    trace["deps"] = trace["deps"] + trace["deps"][:5]  # duplicates collapse
    for kw in ({}, {"capacity": 48}, {"edge_capacity": 512}):
        port, jax = both(trace, total_nodes=8, **kw)
        for f in ("dep_dst", "dep_src"):
            got, want = getattr(port, f).numpy(), np.asarray(getattr(jax, f))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert port.edge_capacity == jax.edge_capacity
        np.testing.assert_array_equal(port.deps.numpy(), np.asarray(jax.deps))


def test_dense_input_equals_pairs():
    trace = workflow_to_trace(montage_like(6, seed=1))
    n = len(trace["submit"])
    dense = np.zeros((n, n), dtype=bool)
    for t, d in trace["deps"]:
        dense[t, d] = True
    a, _ = both(trace, total_nodes=8)
    b, jb = both(dict(trace, deps=dense), total_nodes=8)
    np.testing.assert_array_equal(a.dep_dst.numpy(), b.dep_dst.numpy())
    np.testing.assert_array_equal(b.dep_src.numpy(), np.asarray(jb.dep_src))


def test_n_unmet_and_csr_equal_jax():
    trace = workflow_to_trace(galactic_like(tiles=2, width=5, seed=1))
    port, jax = both(trace, total_nodes=8, capacity=64)
    got = tjobs.SimState.init(port, 8).n_unmet.numpy()
    want = np.asarray(jjobs.SimState.init(jax, 8).n_unmet)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port.deps.numpy().sum(axis=1))
    deps, (start, end) = engine.dep_list(port), jengine.dep_csr(jax)
    rng = np.random.default_rng(0)
    for flags in [np.ones(64, dtype=bool)] + [rng.random(64) < 0.5
                                              for _ in range(4)]:
        got = tjobs.count_deps(deps, torch.from_numpy(flags)).numpy()
        # the JAX engine's release: a cumsum between its CSR bounds
        dec = flags[np.clip(np.asarray(jax.dep_src), 0, 63)].astype(np.int32)
        c = np.concatenate([[0], np.cumsum(dec)])
        np.testing.assert_array_equal(
            got, c[np.asarray(end)] - c[np.asarray(start)])
    plain, _ = both({k: trace[k] for k in ("submit", "runtime", "nodes")},
                    total_nodes=8)
    assert plain.dep_dst is None and engine.dep_list(plain) is None
    assert tjobs.SimState.init(plain, 8).n_unmet is None


def test_refusals_are_the_references():
    trace = dict(submit=[0, 0, 0], runtime=[1, 1, 1], nodes=[1, 1, 1])
    cases = [([(0, 1), (1, 2), (2, 0)], "cycle"), ([(1, 1)], "self-dependency"),
             ([(0, 7)], r"pair \(0,7\) out of range"),
             ([(0, 1), (5, 5)], "out of range"),
             (np.zeros((2, 2), dtype=bool), "expected"),
             (np.eye(3, dtype=bool), "self-dependency")]
    for deps, msg in cases:
        for make in (lambda d: tjobs.make_jobset(**trace, deps=d,
                                                 total_nodes=4, device="cpu"),
                     lambda d: jjobs.make_jobset(**trace, deps=d,
                                                 total_nodes=4)):
            with pytest.raises(ValueError, match=msg):
                make(deps)
    with pytest.raises(ValueError, match="edge_capacity"):
        tjobs.make_jobset(**trace, deps=[(1, 0), (2, 1)], total_nodes=4,
                          edge_capacity=1, device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_assert_acyclic_agrees_with_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(2, 12))
        dense = np.tril(rng.random((n, n)) < 0.3, k=-1)   # acyclic
        if rng.random() < 0.5:   # a chain 0 <- 1 <- ... and i needs j > i
            i, j = sorted(rng.choice(n, 2, replace=False))
            dense |= np.eye(n, k=-1, dtype=bool)
            dense[i, j] = True
        outcomes = []
        for check in (tjobs.assert_acyclic, jjobs.assert_acyclic):
            try:
                check(dense)
                outcomes.append("ok")
            except ValueError as err:
                outcomes.append(str(err))
        assert outcomes[0] == outcomes[1]


def test_deps_follow_the_submit_sort():
    port, _ = both(dict(submit=[50, 0], runtime=[10, 10], nodes=[1, 1],
                        deps=[(0, 1)]), total_nodes=2)
    deps = port.deps.numpy()
    assert deps[1, 0] and deps.sum() == 1
    res = engine.simulate(port, "fcfs", 2, device="cpu")
    assert res.start.numpy()[1] >= res.finish.numpy()[0]


@pytest.mark.parametrize("policy", POLICIES)
def test_no_deps_variants_give_one_schedule(policy):
    rng = np.random.default_rng(11)
    n = 80
    trace = dict(submit=rng.integers(0, 300, n), runtime=rng.integers(1, 70, n),
                 nodes=rng.integers(1, 9, n), estimate=rng.integers(1, 90, n))
    runs = []
    for deps in (None, [], np.zeros((n, n), dtype=bool)):
        jobs = tjobs.make_jobset(**trace, deps=deps, total_nodes=16,
                                 device="cpu")
        assert jobs.dep_dst is None and jobs.deps is None
        runs.append(_fields(engine.simulate(jobs, policy, 16, device="cpu")))
    want = _fields(jengine.simulate(jjobs.make_jobset(**trace, total_nodes=16),
                                    jjobs.POLICY_IDS[policy], 16))
    for got in runs:
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


# ---------------------------------------------------------------------------
# the blocking prefix pass
# ---------------------------------------------------------------------------


def _loop(monkeypatch, *args, **kw):
    """``engine.simulate`` with the per-start loop forced."""
    with monkeypatch.context() as m:
        m.setattr(engine, "_fast_order", lambda *a, **k: None)
        return engine.simulate(*args, device="cpu", **kw)


class _CountingSelector:
    """Counts the selections made through a table's selector."""

    def __init__(self, jobs):
        self.n, sel = 0, jobs.selector
        orig = sel.select

        def select(*a, **k):
            self.n += 1
            return orig(*a, **k)

        sel.select = select


def test_fast_order_eligibility():
    dag = workflow_to_trace(montage_like(6, seed=2))
    with_edges, _ = both(dag, total_nodes=16)
    plain, _ = both({k: dag[k] for k in ("submit", "runtime", "nodes")},
                    total_nodes=16)
    ids = tjobs.POLICY_IDS
    for policy in POLICIES:
        for strategy, capped in ((None, True), (0, True), (1, False),
                                 (2, True), (3, False)):
            got = engine._fast_order(with_edges, ids[policy], strategy)
            want = capped and policy in BLOCKING + ("backfill",)
            assert (got is not None) == want, (policy, strategy)
            got = engine._fast_order(plain, ids[policy], strategy)
            assert (got is not None) == (capped and policy == "backfill")


@pytest.mark.parametrize("policy", BLOCKING)
def test_prefix_pass_equals_loop_and_jax_and_selects_nothing(policy,
                                                              monkeypatch):
    trace = workflow_to_trace(galactic_like(tiles=2, width=5, seed=0))
    port, jax = both(trace, total_nodes=8)
    spy = _CountingSelector(port)
    fast = engine.simulate(port, policy, 8, device="cpu")
    assert spy.n == 0                           # the prefix pass selects none
    slow = _loop(monkeypatch, port, policy, 8)
    assert spy.n > 0
    want = _fields(jengine.simulate(jax, jjobs.POLICY_IDS[policy], 8))
    for got in (_fields(fast), _fields(slow)):
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert fast.n_events == slow.n_events == int(
        jengine.simulate(jax, jjobs.POLICY_IDS[policy], 8).n_events)


@pytest.mark.parametrize("alloc", ("simple", "spread"))
@pytest.mark.parametrize("policy", BLOCKING)
def test_prefix_pass_equals_loop_count_capped(policy, alloc, monkeypatch):
    trace = workflow_to_trace(montage_like(6, seed=2))
    port, jax = both(trace, total_nodes=16)
    kw = dict(machine=rt.Topology.mesh2d(4, 4).build("cpu"), alloc=alloc)
    spy = _CountingSelector(port)
    fast = engine.simulate(port, policy, 16, device="cpu", **kw)
    assert spy.n == 0
    slow = _loop(monkeypatch, port, policy, 16, **kw)
    names = ("start", "finish", "ready", "alloc_first", "alloc_span",
             "alloc_sum", "ev_lfb")
    want = _fields(jengine.simulate(
        jax, jjobs.POLICY_IDS[policy], 16,
        machine=api.Topology.mesh2d(4, 4).build(), alloc=alloc), names)
    for got in (_fields(fast, names), _fields(slow, names)):
        for f in names:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), policy=st.sampled_from(BLOCKING),
       total_nodes=st.sampled_from([8, 16]))
def test_prefix_pass_equals_jax_on_random_dags(seed, policy, total_nodes):
    trace = workflow_to_trace(random_layered(30, 4, p_edge=0.2, seed=seed))
    port, jax = both(trace, total_nodes=total_nodes)
    got = _fields(engine.simulate(port, policy, total_nodes, device="cpu"))
    want = _fields(jengine.simulate(jax, jjobs.POLICY_IDS[policy],
                                    total_nodes))
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_prefix_pass_starts_the_exact_feasible_prefix():
    """Six 2-node jobs and one dependent on 7 nodes: FCFS starts exactly
    three at t = 0 in one event; the dependent releases at 50."""
    n = 7
    trace = dict(submit=np.zeros(n), runtime=np.full(n, 50),
                 nodes=np.full(n, 2), deps=[(6, 0)])
    port, _ = both(trace, total_nodes=7)
    res = engine.simulate(port, "fcfs", 7, device="cpu")
    start = res.start.numpy()
    assert (start[:3] == 0).all() and (start[3:6] == 50).all()
    assert start[6] >= 50
    ref = api.run_ref(api.Scenario(trace=trace, total_nodes=7, policy="fcfs"))
    np.testing.assert_array_equal(start, ref["start"])
    np.testing.assert_array_equal(res.finish.numpy(), ref["finish"])


def test_prefix_pass_generator_makes_one_request():
    gen = engine._pass(tjobs.FCFS, {}, None, True)
    assert next(gen) == ("prefix",)
    with pytest.raises(StopIteration):
        gen.send(None)


# ---------------------------------------------------------------------------
# stacking ragged edge lists
# ---------------------------------------------------------------------------


def _ragged(cap=64):
    dag_a = workflow_to_trace(montage_like(8, seed=0))             # 64
    dag_b = workflow_to_trace(galactic_like(tiles=2, width=8, seed=0))  # 128
    rng = np.random.default_rng(0)
    plain = dict(submit=rng.integers(0, 100, 20),
                 runtime=rng.integers(1, 50, 20), nodes=rng.integers(1, 5, 20))
    return [both(t, capacity=cap, total_nodes=8)
            for t in (dag_a, dag_b, plain)]


def test_stack_jobsets_pads_like_jax():
    pairs = _ragged()
    port = tparallel.stack_jobsets([p for p, _ in pairs])
    jax = jparallel.stack_jobsets([j for _, j in pairs])
    assert pairs[0][0].edge_capacity != pairs[1][0].edge_capacity
    for f in ("dep_dst", "dep_src"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(jax, f)))
    assert (port.dep_dst[2].numpy() == 64).all()
    # a stack of tables without edges carries none
    plain = tparallel.stack_jobsets([pairs[2][0]] * 2)
    assert plain.dep_dst is None


@pytest.mark.parametrize("policy", POLICIES)
def test_ragged_ensemble_members_equal_solo_and_jax(policy):
    pairs = _ragged()
    port = tparallel.stack_jobsets([p for p, _ in pairs])
    jax = jparallel.stack_jobsets([j for _, j in pairs])
    got = tparallel.simulate_ensemble(port, [policy] * 3, [8] * 3,
                                      device="cpu")
    want = jparallel.simulate_ensemble(
        jax, np.full(3, jjobs.POLICY_IDS[policy], np.int32),
        np.full(3, 8, np.int32))
    for f in ("start", "finish", "ready", "wait"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.n_events == np.asarray(want.n_events).tolist()
    for b, (solo, _) in enumerate(pairs):
        one = engine.simulate(solo, policy, 8, device="cpu")
        for f in ("start", "finish", "ready"):
            np.testing.assert_array_equal(getattr(got.member(b), f).numpy(),
                                          getattr(one, f).numpy(), f)


def test_ragged_ensemble_on_a_machine_equals_solo():
    pairs = _ragged()
    tables = [p for p, _ in pairs] * 2
    pols = ["fcfs", "sjf", "backfill", "bestfit", "ljf", "preempt"]
    allocs = ["simple", "spread", "contiguous", "topo", "simple", "topo"]
    machine = rt.Topology.dragonfly(2, 4).build("cpu")
    got = tparallel.simulate_ensemble(
        tparallel.stack_jobsets(tables), pols, [8] * 6, machine=machine,
        alloc_b=allocs, contention=(1, 5), device="cpu")
    for b, t in enumerate(tables):
        one = engine.simulate(t, pols[b], 8, machine=machine,
                              alloc=allocs[b], contention=(1, 5),
                              device="cpu")
        for f in ("start", "finish", "ready", "alloc_sum", "ev_lfb"):
            np.testing.assert_array_equal(getattr(got.member(b), f).numpy(),
                                          getattr(one, f).numpy(), f)


def test_sweep_mixed_edge_counts_match_run_ref():
    scn = rt.Scenario(trace=rt.WorkflowTrace(
        kind="random", params=(("n_tasks", 24), ("n_layers", 4))),
        total_nodes=8, policy="fcfs")
    grid = rt.sweep(scn, axes={"trace.seed": (0, 1, 2),
                               "policy": ("fcfs", "sjf")}, device="cpu")
    assert grid.n_compiles == 1
    for point, res in grid:
        jscn = api.Scenario(trace=api.WorkflowTrace(
            kind="random", seed=point["trace.seed"],
            params=(("n_tasks", 24), ("n_layers", 4))),
            total_nodes=8, policy=point["policy"])
        assert res.matches(api.run_ref(jscn)), point
