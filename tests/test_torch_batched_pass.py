"""The port's batched scheduling passes against the JAX engine's.

``repro_torch.core.engine`` carries the reference's ``blocking_order``,
``_batched_pass`` (the blocking prefix, started in one vectorised update)
and ``_batched_backfill_pass`` (EASY with one shadow walk per event,
DESIGN.md §18.2), and ``_fast_order`` sends backfill through the latter as
``repro.api.run`` does on tables without dependency edges.  Each pass must
leave the state the JAX one leaves, on random mid-run states and on
crafted ones (a release tie at the shadow that overdraws ``extra`` and
takes the ``_redo`` walk; a running set that cannot cover the head); and a
whole batched run must equal the per-start selector loop bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro_torch as rt
from repro import api
from repro.core import engine as jax_engine
from repro.core.engine import _simulate_jit
from repro.core.jobs import make_jobset as jax_make_jobset
from repro_torch.core import engine
from repro_torch.core.jobs import (
    BACKFILL, FCFS, LJF, POLICY_IDS, SJF, WAITING, SimState, make_jobset,
    result_from_state,
)
from test_torch_policies import _assert_state_equal, _jax, _port, _random_case
from test_torch_select_fused import _crafted, _set_running

N_STATES = 200
BLOCKING = {"fcfs": FCFS, "sjf": SJF, "ljf": LJF, "backfill": BACKFILL}
_jit_order = {p: jax.jit(functools.partial(jax_engine.blocking_order,
                                           static_policy=i))
              for p, i in BLOCKING.items()}
_jit_backfill = jax.jit(functools.partial(jax_engine._batched_backfill_pass,
                                          ctx=None))
_jit_prefix = jax.jit(functools.partial(jax_engine._batched_pass, ctx=None))


def _backfill_both(jobs_np, state_np, total):
    jj, js = _jax(jobs_np, state_np, total)
    pj, ps = _port(jobs_np, state_np)
    order = engine.blocking_order(pj, BACKFILL)
    np.testing.assert_array_equal(order.numpy(),
                                  np.asarray(_jit_order["backfill"](jj)))
    want = _jit_backfill(jj, js, order=_jit_order["backfill"](jj))
    engine._batched_backfill_pass(pj, ps, order)
    _assert_state_equal(ps, want)
    return ps


@pytest.mark.parametrize("seed", range(N_STATES))
def test_batched_backfill_pass_matches_jax(seed):
    jobs_np, state_np, total = _random_case(seed)
    _backfill_both(jobs_np, state_np, total)


@pytest.mark.parametrize("policy", sorted(BLOCKING))
@pytest.mark.parametrize("seed", range(0, N_STATES, 8))
def test_batched_prefix_matches_jax(seed, policy):
    jobs_np, state_np, total = _random_case(seed)
    # ties in every key, so the stable order's row tie-break shows
    jobs_np["estimate"] = (jobs_np["estimate"] // 40 * 40 + 1).astype(np.int32)
    jj, js = _jax(jobs_np, state_np, total)
    pj, ps = _port(jobs_np, state_np)
    order = engine.blocking_order(pj, BLOCKING[policy])
    want_order = _jit_order[policy](jj)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    engine._batched_pass(pj, ps, order)
    _assert_state_equal(ps, _jit_prefix(jj, js, order=want_order))


def _redo_state():
    """A blocked head (row 1, 8 nodes) behind one running job (row 0, 6
    nodes, release 150); candidate row 2 (3 nodes) ends exactly at the
    shadow but sorts after the reach entry, so admitting it overdraws
    ``extra`` (2 - 3) and the walk is made again with row 2 in it."""
    jobs_np, state_np = _crafted(6)
    jobs_np["nodes"][:] = [6, 8, 3, 1, 4, 2]
    jobs_np["estimate"][:] = [60, 60, 50, 400, 30, 400]
    _set_running(state_np, [0], [150])
    state_np["free"] = 4
    return jobs_np, state_np, 10


def test_overdraw_takes_the_redo_walk():
    jobs_np, state_np, total = _redo_state()
    engine.reset_counters()
    ps = _backfill_both(jobs_np, state_np, total)
    assert engine.counters["redo"] == 1
    # row 2 ends by the shadow; after the redo, row 3 fits the new extra
    assert (ps.jstate.numpy() == [2, WAITING, 2, 2, WAITING, WAITING]).all()
    assert ps.free == 0


def test_running_set_cannot_cover_the_head():
    jobs_np, state_np = _crafted(6)
    jobs_np["nodes"][:] = [2, 20, 3, 1, 9, 2]
    jobs_np["estimate"][:] = [60, 60, 10**4, 400, 30, 5]
    _set_running(state_np, [0], [150])
    engine.reset_counters()
    # shadow = BIG: every candidate that fits ends by it
    ps = _backfill_both(jobs_np, state_np, 20)
    assert engine.counters["redo"] == 0
    assert (ps.jstate.numpy() == [2, WAITING, 2, 2, WAITING, WAITING]).all()


def test_head_fits_then_blocks():
    """Phase A starts the FCFS prefix, then the new head blocks and the
    window admits behind it."""
    jobs_np, state_np = _crafted(8)
    jobs_np["nodes"][:] = [1, 2, 9, 1, 1, 3, 2, 1]
    state_np["free"] = 6
    ps = _backfill_both(jobs_np, state_np, 12)
    assert ps.jstate.numpy()[:2].tolist() == [2, 2]
    assert ps.jstate.numpy()[2] == WAITING


def test_fast_order_eligibility():
    jobs_np, _, _ = _random_case(1)
    pj, _ = _port(jobs_np, _random_case(1)[1])
    for name, i in POLICY_IDS.items():
        order = engine._fast_order(pj, i)
        assert (order is not None) == (name == "backfill"), name


def _loop_run(jobs, policy, total_nodes):
    """The port's engine with the per-start selector loop for every event
    (no ``_fast_order`` permutation)."""
    state = SimState.init(jobs, total_nodes)
    unfinished = int(jobs.valid.sum())
    while unfinished > 0 and state.n_events < 6 * jobs.capacity + 8:
        unfinished -= engine._event_step(policy, jobs, state,
                                         unfinished=unfinished)
    return result_from_state(jobs, state)


def _assert_runs_equal(a, b, msg=""):
    for f in ("start", "finish", "ready", "wait", "done"):
        np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]),
                                      err_msg=f"{msg}:{f}")
    assert int(a["n_events"]) == int(b["n_events"]), msg


def _three_ways(args, total, **kw):
    """Batched port run, loop port run, and the JAX engine's loop and
    batched runs, all equal."""
    pjobs = make_jobset(*args, total_nodes=total, device="cpu", **kw)
    fast = rt.simulate(pjobs, "backfill", total, device="cpu")
    loop = _loop_run(pjobs, BACKFILL, total)
    jjobs = jax_make_jobset(*args, total_nodes=total, **kw)
    jax_fast = jax_engine.simulate(jjobs, BACKFILL, total)
    jax_loop = _simulate_jit(jjobs, jnp.asarray(BACKFILL, jnp.int32),
                             jnp.asarray(total, jnp.int32), None,
                             max_events=None, static_policy=None,
                             static_strategy=None)
    port = {f: getattr(fast, f).numpy() for f in ("start", "finish", "ready",
                                                 "wait", "done")}
    port["n_events"] = fast.n_events
    _assert_runs_equal(port, {f: getattr(loop, f).numpy() if f != "n_events"
                              else loop.n_events for f in port}, "loop")
    for name, r in (("jax_fast", jax_fast), ("jax_loop", jax_loop)):
        _assert_runs_equal(port, {f: getattr(r, f) for f in port}, name)
    return fast


def test_fast_equals_loop_on_plain_trace():
    # tests/test_engine_fastpath.py's trace, run under backfill
    rng = np.random.default_rng(7)
    n = 120
    args = (rng.integers(0, 400, n), rng.integers(1, 90, n),
            rng.integers(1, 9, n), rng.integers(1, 120, n))
    _three_ways(args, 16)


@pytest.mark.parametrize("seed", range(4))
def test_fast_equals_loop_on_congested_traces(seed):
    rng = np.random.default_rng(100 + seed)
    n = 150
    # few distinct estimates and runtimes, so release ties are common
    est = rng.choice([10, 20, 40, 80], n)
    args = (rng.integers(0, 300, n), np.minimum(est, rng.choice([5, 10, 40],
                                                                n)),
            rng.integers(1, 13, n), est)
    _three_ways(args, 24)


def test_whole_run_takes_the_redo_walk():
    """A trace whose event at t = 1 overdraws the budget: job 0 (6 of 10
    nodes) holds the machine to t = 100; job 1 (8 nodes) blocks; job 2 (3
    nodes) ends exactly at the shadow and sorts after the reach entry."""
    trace = {"submit": np.array([0, 1, 1, 1]),
             "runtime": np.array([100, 50, 99, 30]),
             "nodes": np.array([6, 8, 3, 1]),
             "estimate": np.array([100, 50, 99, 500])}
    args = tuple(trace[k] for k in ("submit", "runtime", "nodes", "estimate"))
    engine.reset_counters()
    res = _three_ways(args, 10)
    assert engine.counters["redo"] >= 1
    assert res.start.tolist() == [0, 100, 1, 1]
    port = rt.run(rt.Scenario(trace=rt.ArrayTrace(**trace), total_nodes=10,
                              policy="backfill"), device="cpu")
    ref = api.run(api.Scenario(trace=api.ArrayTrace(**trace), total_nodes=10,
                               policy="backfill"))
    assert port.matches(ref) and port.summary() == ref.summary()
