"""The port's selectors and engine steps against the JAX package's, state by
state.

Each case draws one random mid-run state with numpy (job table, job
states, clock, free nodes, reservations, priorities including values near
2**29) and hands the identical arrays to both engines: the JAX side as
``repro.core.jobs`` pytrees, the port through ``repro_torch.convert``.
Every comparison is exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import engine as jax_engine
from repro.core import jobs as jax_jobs
from repro.core import policies as jax_policies
from repro_torch import convert
from repro_torch.core import engine, policies
from repro_torch.core.jobs import PENDING, RUNNING, WAITING

J = 48
N_STATES = 200
POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
SELECTORS = {p: i for i, p in enumerate(POLICIES)}


def _random_case(seed: int):
    """(job columns, state fields) as numpy, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(J // 2, J + 1))
    valid = np.arange(J) < n
    submit = np.sort(rng.integers(0, 400, J)).astype(np.int32)
    submit[~valid] = jax_jobs.INF_TIME
    runtime = rng.integers(1, 120, J).astype(np.int32)
    estimate = (runtime + rng.integers(0, 200, J)).astype(np.int32)
    nodes = rng.integers(1, 17, J).astype(np.int32)
    if seed % 2:
        priority = rng.integers(2**29 - 3, 2**29 + 3, J)
    else:
        priority = rng.integers(0, 4, J)
    jobs = {"submit": submit, "runtime": runtime, "estimate": estimate,
            "nodes": nodes, "priority": priority.astype(np.int32),
            "valid": valid}

    clock = int(rng.integers(0, 400))
    jstate = rng.choice([PENDING, WAITING, RUNNING, 3], J,
                        p=[0.2, 0.4, 0.25, 0.15]).astype(np.int32)
    jstate[~valid] = 3
    if not (jstate == WAITING).any():
        jstate[rng.integers(0, n)] = WAITING
    running = jstate == RUNNING
    start = np.where(jstate >= RUNNING,
                     clock - rng.integers(0, 150, J), jax_jobs.INF_TIME)
    remaining = np.maximum(runtime - rng.integers(0, 60, J), 1)
    finish = np.where(running, start + remaining, jax_jobs.INF_TIME)
    finish = np.where(jstate == 3, start + runtime, finish)
    # some running jobs overran their estimate (rsv_finish < clock)
    rsv_finish = np.where(running, start + estimate - rng.integers(0, 300, J),
                          jax_jobs.INF_TIME)
    total_nodes = int(nodes[running].sum() + rng.integers(0, 24))
    state = {"clock": clock, "jstate": jstate,
             "start": start.astype(np.int32), "finish": finish.astype(np.int32),
             "rsv_finish": rsv_finish.astype(np.int32),
             "remaining": remaining.astype(np.int32),
             "free": total_nodes - int(nodes[running].sum()),
             "n_events": int(rng.integers(0, 100))}
    return jobs, state, total_nodes


def _jax(jobs_np, state_np, total_nodes):
    jobs = jax_jobs.JobSet(**{k: jnp.asarray(v) for k, v in jobs_np.items()})
    state = dataclasses.replace(
        jax_jobs.SimState.init(jobs, total_nodes),
        **{k: jnp.asarray(v, dtype=jnp.int32) for k, v in state_np.items()})
    return jobs, state


def _port(jobs_np, state_np):
    return (convert.jobset_from_numpy(jobs_np, "cpu"),
            convert.simstate_from_numpy(state_np, "cpu"))


def _assert_state_equal(port_state, jax_state):
    got = convert.to_numpy(port_state)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jax_state, k)),
                                      err_msg=k)


_jit_select = {p: jax.jit(jax_policies._SELECTORS[i])
               for p, i in SELECTORS.items()}
_jit_shadow = jax.jit(jax_policies.backfill_shadow)
_jit_start = jax.jit(functools.partial(jax_engine._start_job, ctx=None))
_jit_preempt = jax.jit(functools.partial(jax_engine._preempt_for, ctx=None))
_jit_step = {p: jax.jit(functools.partial(jax_engine._event_step,
                                          jnp.int32(i), static_policy=i))
             for p, i in SELECTORS.items()}


@pytest.mark.parametrize("seed", range(N_STATES))
def test_selectors_match(seed):
    jobs_np, state_np, total = _random_case(seed)
    jj, js = _jax(jobs_np, state_np, total)
    pj, ps = _port(jobs_np, state_np)
    for p, i in SELECTORS.items():
        # a geometry-style cap below the free count exercises the cap path
        for cap in (ps.free, max(ps.free - 3, 0)):
            want = int(_jit_select[p](jj, js, jnp.int32(cap)))
            assert policies.select(i, pj, ps, cap) == want, (p, cap)


@pytest.mark.parametrize("seed", range(N_STATES))
def test_backfill_shadow_matches(seed):
    jobs_np, state_np, total = _random_case(seed)
    jj, js = _jax(jobs_np, state_np, total)
    pj, ps = _port(jobs_np, state_np)
    for need in (1, 8, 16, total + 1):
        want = tuple(int(x) for x in _jit_shadow(jj, js, jnp.int32(need)))
        assert policies.backfill_shadow(pj, ps, need) == want, need


@pytest.mark.parametrize("seed", range(N_STATES))
def test_start_and_preempt_match(seed):
    jobs_np, state_np, total = _random_case(seed)
    waiting = np.flatnonzero(state_np["jstate"] == WAITING)
    # the most important waiting job, as select_preempt would pick it
    idx = int(waiting[np.lexsort((waiting,
                                  jobs_np["priority"][waiting]))[0]])
    jj, js = _jax(jobs_np, state_np, total)
    pj, ps = _port(jobs_np, state_np)
    _assert_state_equal(engine._preempt_for(pj, ps, idx),
                        _jit_preempt(jj, js, jnp.int32(idx)))
    jj, js = _jax(jobs_np, state_np, total)
    pj, ps = _port(jobs_np, state_np)
    _assert_state_equal(engine._start_job(pj, ps, idx),
                        _jit_start(jj, js, jnp.int32(idx)))


@pytest.mark.parametrize("seed", range(N_STATES))
def test_event_step_matches(seed):
    jobs_np, state_np, total = _random_case(seed)
    for p, i in SELECTORS.items():
        jj, js = _jax(jobs_np, state_np, total)
        pj, ps = _port(jobs_np, state_np)
        want = _jit_step[p](jj, js)
        completed = int(np.sum((np.asarray(js.jstate) == RUNNING)
                               & (np.asarray(want.jstate) == 3)))
        unfinished = int(((ps.jstate != 3) & pj.valid).sum())
        assert engine._event_step(i, pj, ps,
                                  unfinished=unfinished) == completed, p
        _assert_state_equal(ps, want)


def test_convert_round_trip():
    jobs_np, state_np, _ = _random_case(3)
    pj, ps = _port(jobs_np, state_np)
    for src, obj in ((jobs_np, pj), (state_np, ps)):
        back = convert.to_numpy(obj)
        assert set(back) == set(src)
        for k, v in src.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
