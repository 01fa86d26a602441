"""Ensembles of the port (on the CPU) against the JAX engine's solo runs.

Every member of ``simulate_ensemble`` must equal ``repro.api.run`` of its
own scenario bit for bit in ``start``, ``finish``, ``n_events``,
``makespan`` and ``done``: with mixed policies and node counts, with
members that finish long before the others, and under a ``max_events``
cut.  The batched plain selections and walks (``BatchedTableSelect`` on a
CPU table) must equal the solo plain versions member by member, on random
stacked tables with idle members and mixed modes.
"""

import ctypes

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro import api
from repro_torch.api import build_jobset
from repro_torch.core import engine
from repro_torch.core.parallel import simulate_ensemble, stack_jobsets
from repro_torch.kernels.queue_select import ops, ref

POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
KEYS = ("start", "finish", "n_events", "makespan", "done")


def _ensemble(scenarios, max_events=None):
    jobs = [build_jobset(s, device="cpu") for s in scenarios]
    res = simulate_ensemble(stack_jobsets(jobs), [s.policy for s in scenarios],
                            [s.total_nodes for s in scenarios],
                            max_events=max_events, device="cpu")
    return [rt.Result(scenario=s, raw=res.member(b), jobs=jobs[b])
            for b, s in enumerate(scenarios)], res


def _jax_twin(scn, **kw):
    t = scn.trace
    trace = api.SyntheticTrace(n_jobs=t.n_jobs, seed=t.seed, kind=t.kind,
                               congest=t.congest)
    return api.run(api.Scenario(trace=trace, total_nodes=scn.total_nodes,
                                policy=scn.policy, capacity=scn.capacity,
                                **kw))


def _assert_member(member, want):
    a, b = member.to_np(), want.to_np()
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert member.summary() == want.summary()


@pytest.mark.parametrize("kind,nodes", [("das2", 400), ("sdsc_sp2", 128)])
def test_mixed_policy_ensemble_matches_jax(kind, nodes):
    scns = [rt.Scenario(trace=rt.SyntheticTrace(n_jobs=250, seed=b, kind=kind,
                                                congest=4),
                        total_nodes=nodes // (1 + b % 2), policy=p)
            for b, p in enumerate(POLICIES)]
    members, _ = _ensemble(scns)
    for m, s in zip(members, scns):
        _assert_member(m, _jax_twin(s))


def test_members_that_finish_early_are_frozen():
    """Members of 20, 120 and 250 jobs in one 256-row table: the small ones
    finish many events before the large one, and stay as they were."""
    scns = [rt.Scenario(trace=rt.SyntheticTrace(n_jobs=n, seed=4,
                                                kind="sdsc_sp2", congest=4),
                        total_nodes=128, policy=p, capacity=256)
            for n, p in ((20, "backfill"), (120, "preempt"), (250, "sjf"),
                         (20, "fcfs"))]
    members, res = _ensemble(scns)
    assert res.n_events[0] < res.n_events[1] < res.n_events[2]
    for m, s in zip(members, scns):
        _assert_member(m, _jax_twin(s))
        assert m.to_np()["done"][m.to_np()["valid"]].all()


@pytest.mark.parametrize("cap", (1, 37, 150))
def test_max_events_cut(cap):
    scns = [rt.Scenario(trace=rt.SyntheticTrace(n_jobs=n, seed=7, kind="das2",
                                                congest=4),
                        total_nodes=64, policy=p, capacity=200,
                        max_events=cap)
            for n, p in ((200, "backfill"), (60, "bestfit"), (200, "ljf"))]
    members, res = _ensemble(scns, max_events=cap)
    assert max(res.n_events) == cap
    for m, s in zip(members, scns):
        _assert_member(m, _jax_twin(s, max_events=cap))


def test_one_member_equals_solo_port_run():
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=150, seed=9,
                                              kind="sdsc_sp2", congest=4),
                      total_nodes=128, policy="backfill")
    (member,), _ = _ensemble([scn])
    solo = rt.run(scn, device="cpu")
    for k in KEYS + ("wait", "ready", "valid"):
        np.testing.assert_array_equal(member.to_np()[k], solo.to_np()[k])


def test_ensemble_counts_walks_per_event():
    scns = [rt.Scenario(trace=rt.SyntheticTrace(n_jobs=200, seed=s,
                                                kind="sdsc_sp2", congest=4),
                        total_nodes=128, policy="backfill") for s in (0, 1)]
    engine.reset_counters()
    _ensemble(scns)
    assert engine.counters["max_walks_per_event"] == 1


@pytest.mark.parametrize("arg", ("failures_b", "mesh"))
def test_unported_arguments_raise(arg):
    """``mesh`` is still refused; ``failures_b``, refused before the
    reliability slice, runs, each member equal to its JAX run, and a value
    that is no failure spec is refused."""
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=10), total_nodes=8)
    jobs = stack_jobsets([build_jobset(scn, device="cpu")] * 2)
    if arg == "mesh":
        with pytest.raises(NotImplementedError, match="item 12"):
            simulate_ensemble(jobs, ["fcfs"] * 2, [8] * 2, device="cpu",
                              mesh=object())
        return
    with pytest.raises(TypeError, match="fail ctx"):
        simulate_ensemble(jobs, ["fcfs"] * 2, [8] * 2, device="cpu",
                          failures_b=object())
    fm = [rt.FailureModel(mtbf=m, seed=1, max_failures=16, horizon=2000,
                          requeue=r) for m, r in ((200.0, "requeue"),
                                                  (200.0, "abort"))]
    res = simulate_ensemble(jobs, ["fcfs", "backfill"], [8] * 2,
                            failures_b=fm, device="cpu")
    for b, (f, p) in enumerate(zip(fm, ("fcfs", "backfill"))):
        want = api.run(api.Scenario(
            trace=api.SyntheticTrace(n_jobs=10), total_nodes=8, policy=p,
            failures=api.FailureModel(mtbf=f.mtbf, seed=1, max_failures=16,
                                      horizon=2000, requeue=f.requeue)))
        got = res.member(b)
        np.testing.assert_array_equal(got.finish.numpy(),
                                      np.asarray(want.raw.finish))
        np.testing.assert_array_equal(got.rel.aborted.numpy(),
                                      np.asarray(want.raw.rel.aborted))
        assert got.n_events == int(want.raw.n_events)


@pytest.mark.parametrize("arg", ("machine", "alloc_b", "contention"))
def test_allocation_arguments_run(arg):
    """``machine``, ``alloc_b`` and ``contention``, refused before the
    allocation slice, now run: each member equals its JAX run, and the last
    two still need a machine."""
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=40, seed=1),
                      total_nodes=8, policy="bestfit")
    jobs = stack_jobsets([build_jobset(scn, device="cpu")] * 2)
    topo = rt.Topology.dragonfly(2, 4)
    kw = {"machine": topo.build("cpu")}
    if arg == "alloc_b":
        kw["alloc_b"] = ["topo", "contiguous"]
        with pytest.raises(ValueError, match="require machine"):
            simulate_ensemble(jobs, ["bestfit"] * 2, [8, 8], device="cpu",
                              alloc_b=kw["alloc_b"])
    if arg == "contention":
        kw["contention"] = (1, 5)
        with pytest.raises(ValueError, match="require machine"):
            simulate_ensemble(jobs, ["bestfit"] * 2, [8, 8], device="cpu",
                              contention=(1, 5))
    res = simulate_ensemble(jobs, ["bestfit"] * 2, [8, 8], device="cpu", **kw)
    allocs = kw.get("alloc_b", ["simple", "simple"])
    for b, alloc in enumerate(allocs):
        want = api.run(api.Scenario(
            trace=api.SyntheticTrace(n_jobs=40, seed=1), policy="bestfit",
            topology=api.Topology(topo.kind, topo.shape), alloc=alloc,
            contention=kw.get("contention"))).to_np()
        got = res.member(b)
        for k in ("start", "finish", "alloc_first", "alloc_span",
                  "alloc_sum"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), want[k],
                                          err_msg=k)


def test_stack_jobsets_checks_its_members():
    def table(n, cap):
        return build_jobset(rt.Scenario(trace=rt.SyntheticTrace(n_jobs=n),
                                        total_nodes=8, capacity=cap),
                            device="cpu")
    with pytest.raises(ValueError, match="one capacity"):
        stack_jobsets([table(10, 16), table(10, 32)])
    with pytest.raises(ValueError, match="at least one"):
        stack_jobsets([])
    stacked = stack_jobsets([table(10, 16), table(12, 16)])
    assert stacked.batch == 2 and stacked.capacity == 16
    with pytest.raises(ValueError, match="solo tables"):
        stack_jobsets([stacked])
    with pytest.raises(ValueError, match="stacked table"):
        simulate_ensemble(table(10, 16), ["fcfs"], [8], device="cpu")
    for b, n in enumerate((10, 12)):
        assert int(stacked.member(b).valid.sum()) == n


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no CUDA device")
    jobs = stack_jobsets([build_jobset(
        rt.Scenario(trace=rt.SyntheticTrace(n_jobs=10), total_nodes=8),
        device="cpu")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_ensemble(jobs, ["fcfs"], [8])


# ---------------------------------------------------------------------------
# batched plain selections and walks
# ---------------------------------------------------------------------------

BIG = 2**30 - 1


def _stacked_case(seed, B=5, n=300):
    """A random stacked table and mid-run state: ties in submit and
    estimate, priorities on either side of BIG, reservations before and
    after the clock, and more running rows in some members than others."""
    rng = np.random.default_rng(seed)
    cols = {"submit": np.sort(rng.integers(0, n // 3, (B, n)), axis=1),
            "estimate": rng.choice([60, 600, 3600, 43_200], (B, n)),
            "nodes": rng.integers(1, 129, (B, n)),
            "priority": BIG + rng.integers(-3, 3, (B, n))}
    share = rng.uniform(0.02, 0.4, (B, 1))
    u = rng.random((B, n))
    jstate = np.where(u < share, 2, np.where(u < share + 0.4, 1,
                                             rng.choice([0, 3], (B, n))))
    clock = 50_000
    rsv = np.where(jstate == 2, clock + rng.integers(-3000, 40_000, (B, n)),
                   BIG)
    t = {k: torch.from_numpy(np.asarray(v, np.int32)) for k, v in cols.items()}
    return (ops.BatchedTableSelect(t), torch.from_numpy(jstate.astype(np.int32)),
            torch.from_numpy(rsv.astype(np.int32)), clock, rng)


@pytest.mark.parametrize("seed", range(12))
def test_batched_selections_equal_solo_plain(seed):
    table, jstate, rsv, clock, rng = _stacked_case(seed)
    B = table.batch
    for _ in range(4):
        members = [b for b in range(B) if rng.random() < 0.7]  # idle members
        requests = []
        for b in rng.permutation(members).tolist():
            mode = int(rng.integers(0, len(ref.MODES)))
            p = ref.params(clock=clock, free=int(rng.integers(0, 60)),
                           cap=int(rng.integers(0, 129)),
                           shadow=clock + int(rng.integers(-100, 30_000)),
                           extra=int(rng.integers(-2, 80)),
                           exclude=int(rng.integers(-1, table.n)),
                           tier=BIG + int(rng.integers(-3, 3)))
            requests.append((b, mode, p))
        got = table.select_batch(requests, jstate)
        assert len(got) == len(requests)
        for (b, mode, p), g in zip(requests, got):
            cols = {c: t[b] for c, t in table.cols.items()}
            want = ref.fused_select_reference(mode, cols, jstate[b], *p[:-1])
            assert g == want, (b, mode, p)


@pytest.mark.parametrize("seed", range(12))
def test_batched_walks_equal_solo_plain(seed):
    table, jstate, rsv, clock, rng = _stacked_case(seed)
    members = [b for b in range(table.batch) if rng.random() < 0.7]
    requests = [(b, ref.params(clock=clock, free=int(rng.integers(0, 20)),
                               head_need=int(rng.integers(1, 3000))))
                for b in members]
    got = table.walk_batch(requests, jstate, rsv)
    for (b, p), g in zip(requests, got):
        want = ref.shadow_walk_reference(table.cols["nodes"][b], jstate[b],
                                         rsv[b], p[0], p[1], p[-1])
        assert g == want, (b, p)


def test_batched_references_mark_idle_members():
    table, jstate, rsv, clock, _ = _stacked_case(0, B=3)
    active = [True, False, True]
    modes = [ref.HEAD_SUBMIT, ref.BESTFIT, ref.PREEMPT_TIER]
    params = [dict(zip(ref.PARAMS[:-1], ref.params(free=9, cap=9)[:-1]))] * 3
    got = ref.fused_select_batched_reference(modes, table.cols, jstate,
                                             params, active)
    assert got[1] is None and got[0] is not None and got[2] is not None
    walks = ref.shadow_walk_batched_reference(
        table.cols["nodes"], jstate, rsv,
        [{"clock": clock, "free": 3, "head_need": 50}] * 3, [False, True,
                                                             False])
    assert walks[0] is None and walks[2] is None and walks[1] is not None
    assert table.select_batch([], jstate) == []


def test_batched_table_refuses_bad_requests():
    table, jstate, rsv, _, _ = _stacked_case(1, B=3)
    p = ref.params()
    with pytest.raises(ValueError, match="one request a member"):
        table.select_batch([(0, 0, p), (0, 1, p)], jstate)
    with pytest.raises(ValueError, match="members must lie"):
        table.select_batch([(3, 0, p)], jstate)
    with pytest.raises(ValueError, match="state columns"):
        table.walk_batch([(0, p)], jstate[:2], rsv)
    with pytest.raises(ValueError, match=r"\[B, J\]"):
        ops.BatchedTableSelect({c: t[0] for c, t in table.cols.items()})


def test_batched_requests_pack_into_the_kernels_layout():
    """The host buffer a batched launch reads: one ``SelectArgs`` a request,
    with the member's rows of the columns and of the state, ``n``, the mode
    and the scalars in the kernel's order."""
    table, jstate, rsv, clock, _ = _stacked_case(3, B=4, n=50)
    members = [2, 0, 3]
    words = [(ref.BACKFILL_CAND, *ref.params(clock=clock, free=7, cap=6,
                                             shadow=clock + 9, extra=-2,
                                             exclude=11, tier=BIG,
                                             head_need=40)),
             (ref.PREEMPT_HEAD, *ref.params(tier=BIG - 3)),
             (0, *ref.params(clock=clock, free=1, head_need=2**31 - 1))]
    buf = table._pack(members, jstate, rsv, words)
    for r, (b, w) in enumerate(zip(members, words)):
        a = ops._SelectArgs.from_buffer(buf, r * ctypes.sizeof(ops._SelectArgs))
        for c in ops.COLUMNS:
            assert getattr(a, c) == table.cols[c][b].data_ptr()
        assert a.jstate == jstate[b].data_ptr()
        assert a.rsv_finish == rsv[b].data_ptr()
        assert a.n == 50
        assert [getattr(a, f) for f in ("mode",) + ref.PARAMS] == list(w)
