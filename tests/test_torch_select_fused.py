"""The fused selections and the shadow walk of the port's ``queue_select``
family against the JAX package.

Each mode of ``repro_torch.kernels.queue_select.ref`` builds a key and a
mask from the job table's columns in the kernel.  Here its plain version
(what the wrapper runs on a CPU table, and what the kernel is held to on
the card) must give the row that the JAX package's ``_lex_argmin`` gives on
the key and mask that the JAX selectors build, on the same numpy state; the
plain walk must equal ``repro.core.policies.backfill_shadow``.  Every
comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jobs as jax_jobs
from repro.core import policies as jax_policies
from repro_torch.core.jobs import RUNNING, WAITING
from repro_torch.kernels.queue_select import ops, ref
from test_torch_policies import _jax, _port, _random_case

BIG = ref.BIG
N_STATES = 60
_jit_lex = jax.jit(jax_policies._lex_argmin)
_jit_shadow = jax.jit(jax_policies.backfill_shadow)


def _jax_key_mask(mode, jj, js, p):
    """The key and mask the JAX selectors and batched passes build for
    ``mode`` (``repro/core/policies.py``, ``repro/core/engine.py``)."""
    waiting = js.jstate == WAITING
    idxs = jnp.arange(jj.capacity, dtype=jnp.int32)
    if mode == ref.HEAD_SUBMIT:
        return jj.submit, waiting
    if mode == ref.HEAD_ESTIMATE:
        return jj.estimate, waiting
    if mode == ref.HEAD_NEG_ESTIMATE:
        return -jj.estimate, waiting
    if mode == ref.BESTFIT:
        return p["free"] - jj.nodes, waiting & (jj.nodes <= p["cap"])
    if mode == ref.ANY_FIT:
        return (jnp.zeros_like(jj.nodes),
                waiting & (jj.nodes <= p["cap"]) & (idxs != p["exclude"]))
    if mode == ref.BACKFILL_CAND:
        ends_by = (p["clock"] + jj.estimate) <= p["shadow"]
        within = jj.nodes <= jnp.minimum(p["free"], p["extra"])
        return jj.submit, (waiting & (jj.nodes <= p["cap"])
                           & (idxs != p["exclude"]) & (ends_by | within))
    if mode == ref.PREEMPT_TIER:
        return (jnp.where(waiting, jj.priority, jnp.int32(BIG)),
                jnp.ones_like(waiting))
    if mode == ref.PREEMPT_HEAD:
        return jj.submit, waiting & (jj.priority == p["tier"])
    raise AssertionError(mode)


def _params(jobs_np, state_np, jj, js, cap_cut):
    """The scalars of every mode, as the engine derives them: the FCFS head
    as ``exclude``, its shadow walk's ``shadow``/``extra``, the least
    waiting priority as ``tier``."""
    free = int(state_np["free"])
    waiting = np.flatnonzero(state_np["jstate"] == WAITING)
    head = int(waiting[np.argmin(jobs_np["submit"][waiting])])
    need = int(jobs_np["nodes"][head])
    shadow, extra, _ = (int(x) for x in _jit_shadow(jj, js, jnp.int32(need)))
    prio = np.where(state_np["jstate"] == WAITING, jobs_np["priority"], BIG)
    return {"clock": int(state_np["clock"]), "free": free,
            "cap": max(free - cap_cut, 0), "shadow": shadow, "extra": extra,
            "exclude": head, "tier": int(prio.min())}


def _check_mode(mode, jobs_np, state_np, jj, js, p):
    pj, ps = _port(jobs_np, state_np)
    got = ref.fused_select_reference(mode, pj.selector.cols, ps.jstate, **p)
    # the CPU wrapper is the plain version
    assert pj.selector.select(mode, ps.jstate, **p) == got
    key, mask = _jax_key_mask(mode, jj, js, p)
    want = int(_jit_lex(key, mask))
    assert got[0] == want, (mode, p)
    if want >= 0:
        assert got[1] == int(key[want])
    else:
        assert got[1] == BIG and not bool(jnp.any(mask))
    if mode == ref.PREEMPT_TIER:
        # the reference's min(where(waiting, priority, BIG)) over every row
        assert got[1] == int(jnp.min(key))


@pytest.mark.parametrize("mode", sorted(ref.MODES.values()))
@pytest.mark.parametrize("seed", range(N_STATES))
def test_fused_mode_matches_jax(seed, mode):
    jobs_np, state_np, total = _random_case(seed)
    jj, js = _jax(jobs_np, state_np, total)
    for cap_cut in (0, 3, -5):
        p = _params(jobs_np, state_np, jj, js, cap_cut)
        _check_mode(mode, jobs_np, state_np, jj, js, p)
        # a budget below zero and one past every request
        for extra in (-1, 10**6):
            _check_mode(mode, jobs_np, state_np, jj, js, dict(p, extra=extra))


def _crafted(n=12):
    """A small state with every row's columns set by the caller."""
    jobs_np = {"submit": np.arange(n, dtype=np.int32) // 2,
               "runtime": np.full(n, 50, np.int32),
               "estimate": np.full(n, 60, np.int32),
               "nodes": np.full(n, 2, np.int32),
               "priority": np.zeros(n, np.int32),
               "valid": np.ones(n, bool)}
    state_np = {"clock": 100, "jstate": np.full(n, WAITING, np.int32),
                "start": np.full(n, jax_jobs.INF_TIME, np.int32),
                "finish": np.full(n, jax_jobs.INF_TIME, np.int32),
                "rsv_finish": np.full(n, jax_jobs.INF_TIME, np.int32),
                "remaining": np.full(n, 50, np.int32), "free": 4,
                "n_events": 3}
    return jobs_np, state_np


def _set_running(state_np, rows, rsv):
    state_np["jstate"][rows] = RUNNING
    state_np["start"][rows] = state_np["clock"] - 10
    state_np["finish"][rows] = state_np["clock"] + 40
    state_np["rsv_finish"][rows] = rsv


def test_negative_ljf_keys_and_ties():
    jobs_np, state_np = _crafted()
    jobs_np["estimate"][:] = [5, 9, 9, 1, 9, 3, 9, 2, 7, 9, 9, 4]
    state_np["jstate"][[1, 4]] = RUNNING      # two of the longest not waiting
    jj, js = _jax(jobs_np, state_np, 30)
    p = _params(jobs_np, state_np, jj, js, 0)
    for mode in (ref.HEAD_NEG_ESTIMATE, ref.HEAD_ESTIMATE):
        _check_mode(mode, jobs_np, state_np, jj, js, p)
    pj, ps = _port(jobs_np, state_np)
    assert pj.selector.select(ref.HEAD_NEG_ESTIMATE, ps.jstate) == (2, -9)


def test_priorities_above_big():
    jobs_np, state_np = _crafted()
    jobs_np["priority"][:] = BIG + np.arange(12, 0, -1)
    jobs_np["priority"][7] = 2**31 - 1
    # every row waiting: the tier is the least priority, above BIG
    jj, js = _jax(jobs_np, state_np, 30)
    p = _params(jobs_np, state_np, jj, js, 0)
    assert p["tier"] == BIG + 1
    for mode in (ref.PREEMPT_TIER, ref.PREEMPT_HEAD):
        _check_mode(mode, jobs_np, state_np, jj, js, p)
    pj, ps = _port(jobs_np, state_np)
    assert pj.selector.select(ref.PREEMPT_TIER, ps.jstate) == (11, BIG + 1)
    assert pj.selector.select(ref.PREEMPT_HEAD, ps.jstate,
                              tier=BIG + 1) == (11, 5)
    # one row not waiting: its BIG beats every waiting priority
    state_np["jstate"][3] = RUNNING
    jj, js = _jax(jobs_np, state_np, 30)
    p = _params(jobs_np, state_np, jj, js, 0)
    assert p["tier"] == BIG
    for mode in (ref.PREEMPT_TIER, ref.PREEMPT_HEAD):
        _check_mode(mode, jobs_np, state_np, jj, js, p)


def _walk_both(jobs_np, state_np, need):
    jj, js = _jax(jobs_np, state_np, 64)
    pj, ps = _port(jobs_np, state_np)
    want = tuple(int(x) for x in _jit_shadow(jj, js, jnp.int32(need)))
    got = ref.shadow_walk_reference(pj.nodes, ps.jstate, ps.rsv_finish,
                                    ps.clock, ps.free, need)
    assert got == want, need
    assert ops.shadow_walk(pj.selector, ps.jstate, ps.rsv_finish, ps.clock,
                           ps.free, need) == got
    return got


def test_walk_release_tie_at_the_shadow():
    jobs_np, state_np = _crafted()
    jobs_np["nodes"][[0, 3, 5]] = [3, 2, 4]
    _set_running(state_np, [0, 3, 5], [150, 150, 150])
    # ties at 150 break by row: 0 (3 nodes) then 3 (2) then 5 (4)
    assert _walk_both(jobs_np, state_np, 7) == (150, 0, 0)
    assert _walk_both(jobs_np, state_np, 8) == (150, 1, 3)
    assert _walk_both(jobs_np, state_np, 9) == (150, 0, 3)
    assert _walk_both(jobs_np, state_np, 13) == (150, 0, 5)


def test_walk_cannot_cover_the_head():
    jobs_np, state_np = _crafted()
    _set_running(state_np, [1, 2], [130, 170])
    assert _walk_both(jobs_np, state_np, 9) == (BIG, 4, -1)
    state_np["jstate"][[1, 2]] = WAITING      # no running job at all
    assert _walk_both(jobs_np, state_np, 9) == (BIG, 4, -1)


def test_walk_counts_one_release_and_clamps_overruns():
    jobs_np, state_np = _crafted()
    # overran estimates release "at clock + 1", ties by row
    _set_running(state_np, [6, 2, 9], [40, 90, 400])
    # free alone covers a need of 1, but one release is always counted
    assert _walk_both(jobs_np, state_np, 1) == (101, 5, 2)
    assert _walk_both(jobs_np, state_np, 8) == (101, 0, 6)
    assert _walk_both(jobs_np, state_np, 9) == (400, 1, 9)


def test_walk_releases_in_row_order_past_one_thread():
    """More running rows than one kernel thread holds at small sizes, and
    equal release times spread over the table."""
    rng = np.random.default_rng(4)
    n = 300
    jobs_np, state_np = _crafted(n)
    jobs_np["nodes"][:] = rng.integers(1, 5, n)
    rows = np.flatnonzero(rng.random(n) < 0.6)
    _set_running(state_np, rows, rng.integers(90, 110, rows.size))
    total = int(jobs_np["nodes"][rows].sum())
    for need in (1, 50, total // 2, total, total + 4, total + 5):
        _walk_both(jobs_np, state_np, need)


def test_unknown_mode_and_bad_columns_raise():
    jobs_np, state_np = _crafted()
    pj, ps = _port(jobs_np, state_np)
    with pytest.raises(ValueError, match="mode"):
        pj.selector.select(99, ps.jstate)
    cols = dict(pj.selector.cols, nodes=pj.nodes.to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        ops.TableSelect(cols)
    with pytest.raises(ValueError, match="like submit"):
        ops.TableSelect(dict(pj.selector.cols, estimate=pj.estimate[:5]))
