"""The conservative window step of the PyTorch port against the JAX
engine's, on the CPU.

- ``next_event_time`` on random mid-run states, with and without edges;
- solo windows (``engine.simulate_window``) at widths 1,000, 7,000 and
  ``INF_TIME`` equal to ``repro.core.engine.simulate_window`` round for
  round (every state field and the ``saturated`` flag) and, composed, to
  the one-shot run; forced saturation under a small cap, continued to the
  same schedule;
- releases landing in a later round (a chain whose tasks outlast the
  window), on a machine with a DAG under ``contiguous``, a failure stream
  crossing rounds, and an edge neutralized in the middle of the list (the
  list loses its dst order; the window's scatter-add release must still
  equal the reference's);
- a drain at ``INF_TIME`` that does not spin, with a PENDING invalid row;
- the lockstep window (``engine.simulate_window_batch``) against C solo
  windows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api
from repro.core import engine as jengine
from repro.core.jobs import SimState as JaxSimState
from repro.core.jobs import make_jobset as jax_make_jobset
from repro.reliability.model import merge_stream as jax_merge_stream
from repro.traces import das2_like

import repro_torch as rt
from repro_torch.core import engine
from repro_torch.core.jobs import (
    DONE, INF_TIME, PENDING, POLICY_IDS, RUNNING, WAITING, SimState,
    make_jobset,
)
from repro_torch.core.parallel import stack_jobsets
from repro_torch.reliability.model import make_fail_ctx

FIELDS = ("jstate", "start", "finish", "rsv_finish", "remaining")
SCALARS = ("clock", "free", "n_events")


def tables(trace: dict, total_nodes: int, **kw):
    """The port's (on the CPU) and the JAX package's table of a trace."""
    args = (trace["submit"], trace["runtime"], trace["nodes"],
            trace.get("estimate"), trace.get("priority"))
    kw = dict(deps=trace.get("deps"), total_nodes=total_nodes, **kw)
    return make_jobset(*args, device="cpu", **kw), jax_make_jobset(*args, **kw)


def state_diff(port: SimState, ref, edges=False, machine=False,
               rel=False) -> list:
    """The state fields where the port's state differs from the JAX
    engine's."""
    bad = [f for f in FIELDS if not np.array_equal(
        getattr(port, f).numpy(), np.asarray(getattr(ref, f)))]
    bad += [f for f in SCALARS if getattr(port, f) != int(getattr(ref, f))]
    if edges and not np.array_equal(port.n_unmet.numpy(),
                                    np.asarray(ref.n_unmet)):
        bad.append("n_unmet")
    if machine:
        for i, f in enumerate(("alloc_first", "alloc_span", "alloc_sum")):
            if not np.array_equal(port.alloc[i].numpy(),
                                  np.asarray(getattr(ref, f))):
                bad.append(f)
        if not np.array_equal(port.node_owner.numpy(),
                              np.asarray(ref.node_owner)):
            bad.append("node_owner")
    if rel:
        for f in ("last_start", "n_restarts", "lost_work", "aborted"):
            if not np.array_equal(getattr(port.rel, f).numpy(),
                                  np.asarray(getattr(ref.rel, f))):
                bad.append(f"rel.{f}")
        if port.rel.ptr[0] != int(ref.rel.ptr):
            bad.append("rel.ptr")
    return bad


def jax_rel(ft) -> tuple:
    """The JAX window's merged failure stream of a materialized trace."""
    t, n, k = jax_merge_stream(ft)
    return tuple(jnp.asarray(x, jnp.int32) for x in (
        t, n, k, ft.requeue, ft.checkpoint_interval, ft.restart_overhead))


def jax_window(pid: int, cap: int, ctx=None, rel=None):
    """The JAX engine's window, compiled once for every ``t_hi`` (the
    replay runner's form: policy, context and stream closed over)."""
    return jax.jit(lambda jobs, st, t_hi: jengine.simulate_window(
        jnp.int32(pid), jobs, st, t_hi, cap, ctx, rel=rel))


def windows(policy, pt, jt, total_nodes, width, cap, rounds, *,
            machine=None, alloc=None, failures=None, edges=False):
    """Step both engines' windows of ``width`` for ``rounds`` rounds and a
    drain, comparing the states and flags after every call; returns the
    port's final state."""
    pid = POLICY_IDS[policy]
    pm = jm = pctx = jctx = None
    if machine is not None:
        pm, jm = rt.Topology(*machine).build("cpu"), \
            api.Topology(*machine).build()
        pctx = engine.make_alloc_ctx(pm, alloc, None)
        jctx = jengine.make_alloc_ctx(jm, alloc, None)
    ps = SimState.init(pt, total_nodes, pm, cap,
                       None if failures is None
                       else make_fail_ctx(failures[0]))
    js = JaxSimState.init(jt, total_nodes, machine=jm, event_log=cap,
                          failures=failures is not None)
    prel = None if failures is None else failures[0]
    jrel = None if failures is None else jax_rel(failures[1])
    step = jax_window(pid, cap, jctx, jrel)
    bounds = [(r + 1) * width for r in range(rounds)] + [INF_TIME]
    for t_hi in bounds:
        ps, psat = engine.simulate_window(pid, pt, ps, t_hi, cap, pctx,
                                          rel=prel)
        js, jsat = step(jt, js, np.int32(t_hi))
        assert psat == bool(jsat), t_hi
        assert state_diff(ps, js, edges, machine is not None,
                          failures is not None) == [], t_hi
    return ps


def one_shot(policy, pt, total_nodes, **kw):
    return engine.simulate(pt, policy, total_nodes, device="cpu", **kw)


# ---------------------------------------------------------------------------
# next_event_time
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("edges", (False, True), ids=("plain", "edges"))
@pytest.mark.parametrize("seed", range(4))
def test_next_event_time_on_random_states(seed, edges):
    rng = np.random.default_rng(seed)
    J = 40
    trace = {"submit": rng.integers(0, 500, J),
             "runtime": rng.integers(1, 300, J),
             "nodes": rng.integers(1, 8, J)}
    if edges:
        trace["deps"] = [(int(i), int(rng.integers(0, i)))
                         for i in range(1, J) if rng.random() < 0.4]
    pt, jt = tables(trace, 16, capacity=48)
    js = JaxSimState.init(jt, 16)
    ps = SimState.init(pt, 16)
    for _ in range(5):
        jstate = rng.choice([PENDING, WAITING, RUNNING, DONE], 48).astype(
            np.int32)
        finish = rng.integers(0, 2000, 48).astype(np.int32)
        jstate[J:] = DONE
        js = dataclasses.replace(js, jstate=jstate, finish=finish)
        ps.jstate = torch.from_numpy(jstate)
        ps.finish = torch.from_numpy(finish)
        if edges:
            unmet = rng.integers(0, 2, 48).astype(np.int32)
            js = dataclasses.replace(js, n_unmet=unmet)
            ps.n_unmet = torch.from_numpy(unmet)
        assert engine.next_event_time(pt, ps) == int(
            jengine.next_event_time(jt, js))


# ---------------------------------------------------------------------------
# solo windows, round for round
# ---------------------------------------------------------------------------

SOLO = das2_like(150, seed=3)


@pytest.mark.parametrize("width", (1000, 7000, INF_TIME))
@pytest.mark.parametrize("policy", ("fcfs", "sjf", "backfill", "preempt"))
def test_solo_windows_round_for_round(policy, width):
    pt, jt = tables(SOLO, 64)
    rounds = 0 if width == INF_TIME else int(SOLO["submit"].max()) // width + 2
    cap = 2 * pt.capacity + 8
    ps = windows(policy, pt, jt, 64, width, cap, rounds)
    one = one_shot(policy, pt, 64)
    assert torch.equal(ps.start, one.start)
    assert torch.equal(ps.finish, one.finish)
    assert ps.n_events == one.n_events


def test_forced_saturation_resumes_to_the_same_schedule():
    """A cap far below the round's events saturates; raising it and
    calling again continues the valid prefix to the one-shot schedule."""
    pt, jt = tables(SOLO, 64)
    pid = POLICY_IDS["backfill"]
    ps, js = SimState.init(pt, 64), JaxSimState.init(jt, 64)
    step = jax.jit(lambda jobs, st, cap: jengine.simulate_window(
        jnp.int32(pid), jobs, st, INF_TIME, cap))
    cap, saturations = 10, 0
    while True:
        ps, psat = engine.simulate_window(pid, pt, ps, INF_TIME, cap)
        js, jsat = step(jt, js, jnp.int32(cap))
        assert psat == bool(jsat)
        assert state_diff(ps, js) == []
        if not psat:
            break
        saturations += 1
        cap += 10
    assert saturations > 5
    assert torch.equal(ps.start, one_shot("backfill", pt, 64).start)


# ---------------------------------------------------------------------------
# releases, machines, failures and neutralized edges across rounds
# ---------------------------------------------------------------------------


def test_release_lands_in_a_later_round():
    """Chain tasks run 100 s each, the window is 30 s: every release falls
    3+ rounds after its dependent was loaded."""
    trace = api.WorkflowTrace(kind="chain", params=(
        ("n", 4), ("exec_time", 100))).materialize()
    pt, jt = tables(trace, 4)
    ps = windows("fcfs", pt, jt, 4, 30, 8 * pt.capacity + 8, 20,
                 edges=True)
    one = one_shot("fcfs", pt, 4)
    assert torch.equal(ps.start, one.start)
    assert torch.equal(ps.finish, one.finish)


def test_window_with_alloc_ctx_and_deps():
    trace = api.WorkflowTrace(kind="montage", params=(
        ("width", 6),)).materialize()
    pt, jt = tables(trace, 16)
    ps = windows("backfill", pt, jt, 16, 25, 8 * pt.capacity + 8, 40,
                 machine=("mesh2d", (4, 4)), alloc="contiguous", edges=True)
    one = one_shot("backfill", pt, 16,
                   machine=rt.Topology.mesh2d(4, 4).build("cpu"),
                   alloc="contiguous")
    assert torch.equal(ps.start, one.start)
    assert torch.equal(ps.alloc, torch.stack(
        [one.alloc_first, one.alloc_span, one.alloc_sum]))


@pytest.mark.parametrize("requeue", ("requeue", "abort"))
def test_failure_stream_crosses_rounds(requeue):
    """Kills, restarts and repairs at round boundaries fire at the same
    clock as the reference's."""
    kw = dict(mtbf=20_000.0, mean_repair=2_000, horizon=1 << 19, seed=7,
              max_failures=64, checkpoint_interval=500, restart_overhead=20,
              requeue=requeue)
    ft = (rt.FailureModel(**kw).materialize(64),
          api.FailureModel(**kw).materialize(64))
    pt, jt = tables(SOLO, 64)
    cap = 6 * pt.capacity + 6 * 64 + 8
    ps = windows("fcfs", pt, jt, 64, 3000,
                 cap, int(SOLO["submit"].max()) // 3000 + 2, failures=ft)
    assert int(ps.rel.n_restarts.sum() + ps.rel.aborted.sum()) > 0
    one = one_shot("fcfs", pt, 64, failures=ft[0])
    assert torch.equal(ps.start, one.start)
    assert torch.equal(ps.finish, one.finish)


def test_edge_neutralized_mid_list_releases_as_jax():
    """An edge in the middle of the list set to the pad index on both
    ends (as a multicluster import does): the list is no longer
    dst-sorted, and the window releases by scatter-add as the
    reference's does."""
    trace = api.WorkflowTrace(kind="montage", params=(
        ("width", 8),)).materialize()
    pt, jt = tables(trace, 8)
    E = int((pt.dep_dst < pt.capacity).sum())
    dst, src = pt.dep_dst.clone(), pt.dep_src.clone()
    dst[E // 2] = src[E // 2] = pt.capacity
    assert not bool((dst[1:] >= dst[:-1]).all())
    pt = dataclasses.replace(pt, dep_dst=dst, dep_src=src)
    jt = dataclasses.replace(jt, dep_dst=dst.numpy(), dep_src=src.numpy())
    windows("fcfs", pt, jt, 8, 40, 8 * pt.capacity + 8, 30, edges=True)


def test_drain_at_inf_does_not_spin():
    """A drain of a finished table makes no event and reads unsaturated;
    a PENDING invalid row (replay's sentinel) keeps the count open but is
    never due, so the drain ends at once too."""
    pt, _ = tables(SOLO, 64, capacity=160)
    ps = SimState.init(pt, 64)
    ps, sat = engine.simulate_window("fcfs", pt, ps, INF_TIME, 10_000)
    n = ps.n_events
    assert not sat
    ps, sat = engine.simulate_window("fcfs", pt, ps, INF_TIME, 10_000)
    assert (ps.n_events, sat) == (n, False)
    ps.jstate[-1] = PENDING
    ps, sat = engine.simulate_window("fcfs", pt, ps, INF_TIME, n + 1)
    assert (ps.n_events, sat) == (n, False)


def test_window_refuses_what_the_reference_lacks():
    pt, _ = tables(SOLO, 64)
    st = SimState.init(pt, 64)
    with pytest.raises(ValueError, match="rel="):
        engine.simulate_window("fcfs", pt, st, 100, 100,
                               rel=rt.FailureModel(
                                   mtbf=1e4, horizon=1 << 16,
                                   max_failures=8).materialize(64))


# ---------------------------------------------------------------------------
# the lockstep window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ("fcfs", "backfill"))
def test_lockstep_window_equals_solo_windows(policy):
    """C members of a stacked table in lockstep, window after window,
    equal to each member's solo windows (every state field, every
    saturated flag)."""
    traces = [das2_like(60 + 20 * c, seed=40 + c) for c in range(3)]
    solos = [make_jobset(t["submit"], t["runtime"], t["nodes"],
                         t["estimate"], capacity=120, total_nodes=64,
                         device="cpu") for t in traces]
    pid = POLICY_IDS[policy]
    cap = 2 * 120 + 8
    run = engine._BatchRun(stack_jobsets(solos), [pid] * 3, [64] * 3, cap)
    states = [SimState.init(j, 64) for j in solos]
    width = 2500
    horizon = max(int(t["submit"].max()) for t in traces)
    for t_hi in [(r + 1) * width for r in range(horizon // width + 2)] + [
            INF_TIME]:
        sat = engine.simulate_window_batch(run, t_hi, cap)
        for b, j in enumerate(solos):
            states[b], s = engine.simulate_window(pid, j, states[b], t_hi,
                                                  cap)
            assert sat[b] == s
            for f in FIELDS:
                assert torch.equal(getattr(run.state, f)[b],
                                   getattr(states[b], f)), (t_hi, b, f)
            m = run.state.members[b]
            assert (m.clock, m.free, m.n_events) == (
                states[b].clock, states[b].free, states[b].n_events)
