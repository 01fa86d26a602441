"""The port's batched pool engine (``simulate_workflow_ensemble``) and the
batched generic ``queue_select`` entry's plain version, on the CPU.

A stack of workflows run in lockstep must equal the reference's
``jax.vmap(repro.core.workflow.simulate_workflow)`` over the same stacked
inputs bit for bit on ``tstate``, ``start``, ``finish``, ``free``, the
clock and ``n_events``, and each member must equal its solo run at the
stack's capacity, on ragged members, mixed policies and pools, a cut by
``max_events``, a member whose priorities reach ``INF_TIME`` beside
members on the kernel, one member, and Fig. 6's copies of one DAG.  Each
selection sub-round is one batched selection for the members still
selecting on the kernel.  ``queue_select_batched_reference`` equals one
``queue_select_reference`` call a row, all-infeasible rows and ties
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import workflow as jwf
from repro_torch.core import workflow as twf
from repro_torch.kernels.queue_select import ops
from repro_torch.kernels.queue_select.ref import (
    BIG, queue_select_batched_reference, queue_select_reference,
)
from repro_torch.traces import workflows as TW

STATE = ("tstate", "start", "finish", "free")


def _members(case):
    """(workflows, policies, pools, priorities, max_events) of a case."""
    gal = TW.galactic_like(3, 8, seed=1)
    if case == "fig6_copies":
        wf = TW.galactic_like(2, 6, seed=9)
        return [wf] * 6, ["fcfs_fit"] * 6, [[64, 1 << 20]] * 6, None, None
    if case == "one_member":
        return [gal], ["cpath"], [[16, 16384]], None, None
    wfs = [gal, TW.sipht_like(12, seed=2), TW.random_layered(60, 6, seed=3),
           TW.fork_join(5, 3, seed=4), TW.chain(9)]
    pols = ["fcfs", "fcfs_fit", "cpath", "fcfs", "fcfs_fit"]
    pools = [[16, 16384], [8, 8192], [4, 4000], [3, 8192], [2, 100]]
    prios = None
    max_events = 11 if case == "cut" else None
    if case == "inf_priority":
        n = len(wfs[3]["exec_time"])
        prio = np.arange(n, dtype=np.int64)
        prio[1::2] = twf.INF_TIME + 3
        prios = [None, None, None, prio, None]
    return wfs, pols, pools, prios, max_events


CASES = ("ragged_mixed", "cut", "inf_priority", "one_member", "fig6_copies")


def _run_case(case):
    wfs, pols, pools, prios, max_events = _members(case)
    prios = [rt.critical_path_length(w["exec_time"], w["dep_pairs"])
             if p == "cpath" else (prios[i] if prios else None)
             for i, (w, p) in enumerate(zip(wfs, pols))]
    tasks = [rt.make_taskset(w["exec_time"], w["resources"], w["dep_pairs"],
                             priority=pr, device="cpu")
             for w, pr in zip(wfs, prios)]
    stack = rt.stack_tasksets(tasks)
    pools = np.asarray(pools)
    state = rt.simulate_workflow_ensemble(stack, pools, pols,
                                          max_events=max_events,
                                          device="cpu")
    return wfs, pols, pools, prios, max_events, stack, state


@pytest.mark.parametrize("case", CASES)
def test_ensemble_equals_jax_vmap(case):
    wfs, pols, pools, prios, max_events, stack, state = _run_case(case)
    T = stack.capacity
    jts = [jwf.make_taskset(w["exec_time"], w["resources"], w["dep_pairs"],
                            priority=pr, capacity=T)
           for w, pr in zip(wfs, prios)]
    batched = jax.tree.map(lambda *x: jnp.stack(x), *jts)
    fn = jax.jit(jax.vmap(lambda t, p, q: jwf.simulate_workflow(
        t, p, q, max_events=max_events)))
    want = fn(batched, jnp.asarray(pools, jnp.int32),
              jnp.asarray([jwf.WF_POLICY_IDS[p] for p in pols], jnp.int32))
    for k in STATE:
        got = getattr(state, k).numpy()
        w = np.asarray(getattr(want, k))
        assert got.dtype == w.dtype, k
        np.testing.assert_array_equal(got, w, err_msg=k)
    assert state.n_events == np.asarray(want.n_events).tolist()
    assert state.clock == np.asarray(want.clock).tolist()
    if max_events is not None:
        assert max(state.n_events) == max_events


@pytest.mark.parametrize("case", CASES)
def test_each_member_equals_its_solo_run(case):
    wfs, pols, pools, prios, max_events, stack, state = _run_case(case)
    for b in range(stack.batch):
        member = stack.member(b)
        solo = rt.simulate_workflow(member, pools[b], pols[b],
                                    max_events=max_events, device="cpu")
        got = rt.workflow_result_np(member, state.member(b))
        want = rt.workflow_result_np(member, solo)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(b, k))
        np.testing.assert_array_equal(state.free[b].numpy(),
                                      solo.free.numpy())
        assert state.clock[b] == solo.clock


def test_one_batched_selection_a_sub_round(monkeypatch):
    """Every call of the batched entry asks for the members still
    selecting on the kernel, never for the member on the plain path, and
    a member is asked again only after it started a task."""
    calls = []

    def counted(scores, feasible, members):
        calls.append(list(members))
        return ops.queue_select_batch(scores, feasible, members)

    monkeypatch.setattr(twf, "queue_select_batch", counted)
    *_, stack, state = _run_case("inf_priority")
    assert calls and all(3 not in c for c in calls)
    assert calls[0] == [0, 1, 2, 4]      # the initial pass of every member
    started = int((state.start.numpy() < twf.INF_TIME).sum())
    n_events = sum(state.n_events)
    # a call is a selection of each member named: one a start, plus one
    # that ends each member's pass (the initial one and one an event)
    plain_starts = int((state.start[3].numpy() < twf.INF_TIME).sum())
    selections = sum(len(c) for c in calls)
    plain_passes = 1 + state.n_events[3]
    assert selections == (started - plain_starts) + (stack.batch - 1) \
        + (n_events - state.n_events[3])
    assert plain_passes > 1


def test_stack_pads_ragged_members():
    a = rt.make_taskset([3, 4, 5], [[1, 1]] * 3, [(2, 0), (2, 1)],
                        device="cpu")
    b = rt.make_taskset([7], [[2, 2]], [], priority=[9], device="cpu")
    s = rt.stack_tasksets([a, b])
    assert s.batch == 2 and s.capacity == 3 and a.batch is None
    assert s.exec_time[1].tolist() == [7, 1, 1]
    assert s.resources[1].tolist() == [[2, 2], [0, 0], [0, 0]]
    assert s.valid[1].tolist() == [True, False, False]
    assert s.priority[1].tolist() == [9, 1, 2]
    assert s.dep_dst[1].tolist() == [3, 3] and s.dep_src[1].tolist() == [3, 3]
    for m, orig in ((s.member(0), a), (s.member(1), b)):
        for f in ("dep_dst", "dep_src"):
            assert getattr(m, f).tolist() == getattr(orig, f).tolist()
    with pytest.raises(ValueError, match="resource"):
        rt.stack_tasksets([a, rt.make_taskset([1], [[1]], [], device="cpu")])
    with pytest.raises(ValueError, match="solo"):
        rt.stack_tasksets([s])
    with pytest.raises(ValueError, match="stacked"):
        rt.simulate_workflow_ensemble(a, [4, 4], "fcfs", device="cpu")
    # one pool vector and one policy serve every member
    one = rt.simulate_workflow_ensemble(s, [4, 4], "fcfs_fit", device="cpu")
    each = rt.simulate_workflow_ensemble(s, [[4, 4], [4, 4]],
                                         ["fcfs_fit", 1], device="cpu")
    for k in STATE:
        assert torch.equal(getattr(one, k), getattr(each, k))


@pytest.mark.parametrize("case", ("random", "all_infeasible", "ties",
                                  "big_scores", "int32_mask", "one_row"))
def test_batched_reference_equals_solo_calls(case):
    rng = np.random.default_rng(len(case))
    B, T = (1, 7) if case == "one_row" else (6, 50)
    scores = rng.integers(-5, 5, (B, T))
    feasible = rng.random((B, T)) < 0.3
    if case == "all_infeasible":
        feasible[[0, 2, 5]] = False
    if case == "ties":
        scores[:] = 2
    if case == "big_scores":
        scores[1] = BIG
        scores[2, ::2] = BIG + 5
    s = torch.from_numpy(scores.astype(np.int32))
    f = torch.from_numpy(feasible)
    if case == "int32_mask":
        f = f.to(torch.int32)
    members = [0] if case == "one_row" else [5, 2, 0, 0, 3, 1, 4]
    got = queue_select_batched_reference(s, f, members)
    want = [tuple(queue_select_reference(s[b], f[b]).tolist())
            for b in members]
    assert got == want
    assert ops.queue_select_batch(s, f, members) == want
    if case == "all_infeasible":
        assert got[1] == (-1, BIG)


def test_batched_entry_checks_its_inputs():
    s = torch.zeros((3, 4), dtype=torch.int32)
    f = torch.ones((3, 4), dtype=torch.bool)
    assert ops.queue_select_batch(s, f, []) == []
    with pytest.raises(ValueError, match="members"):
        ops.queue_select_batch(s, f, [3])
    with pytest.raises(TypeError, match="int32"):
        ops.queue_select_batch(s.long(), f, [0])
    with pytest.raises(ValueError, match="2-D"):
        ops.queue_select_batch(s[0], f[0], [0])
