"""Machine-mode ensembles and sweeps of the port (on the CPU) against the
JAX engine.

Every member of ``simulate_ensemble`` with a machine (one strategy and one
contention model a member, mixed within the batch) must equal
``repro.api.run`` of its own scenario on every key of the allocation
schema; ``simulate_alloc_sweep`` must equal the reference's member by
member and the port's solo runs; ``sweep`` over the ``alloc`` and
``contention`` axes (with policies, and across topologies) must give the
reference's points, ``n_compiles``, results and summaries, and
``cache_stats`` must count the reference's compiles and hits.
"""

import numpy as np
import pytest

import repro_torch as rt
from repro import api
from repro.core import parallel as jax_parallel
from repro_torch.api import build_jobset, build_machine
from repro_torch.core import engine
from repro_torch.core.parallel import simulate_ensemble, stack_jobsets

POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
STRATEGIES = ("simple", "contiguous", "spread", "topo")
CONTENTIONS = (None, (1, 5))
TRACE = dict(n_jobs=120, seed=5, kind="sdsc_sp2", congest=4)
ALLOC_KEYS = ("start", "finish", "n_events", "makespan", "done",
              "alloc_first", "alloc_span", "alloc_sum", "ev_time", "ev_free",
              "ev_lfb")


def _pair(topology=("dragonfly", (8, 8)), trace=TRACE, **kw):
    return (rt.Scenario(trace=rt.SyntheticTrace(**trace),
                        topology=rt.Topology(*topology), **kw),
            api.Scenario(trace=api.SyntheticTrace(**trace),
                         topology=api.Topology(*topology), **kw))


def _same(a, b, keys=ALLOC_KEYS, what=""):
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _ensemble(base, cases, max_events=None):
    """Members ``cases`` (policy, alloc, contention) over ``base``'s table
    and machine; their ``Result``s."""
    jobs = build_jobset(base, device="cpu")
    B = len(cases)
    res = simulate_ensemble(
        stack_jobsets([jobs] * B), [c[0] for c in cases],
        [base.total_nodes] * B, machine=build_machine(base, "cpu"),
        alloc_b=[c[1] for c in cases], contention=[c[2] for c in cases],
        max_events=max_events, device="cpu")
    return [rt.Result(scenario=base.with_(policy=p, alloc=a, contention=c),
                      raw=res.member(b), jobs=jobs)
            for b, (p, a, c) in enumerate(cases)]


@pytest.mark.parametrize("policy", POLICIES)
def test_mixed_strategy_ensemble_matches_jax(policy):
    port, ref = _pair()
    cases = [(policy, a, c) for a in STRATEGIES for c in CONTENTIONS]
    for member, (p, a, c) in zip(_ensemble(port, cases), cases):
        want = api.run(ref.with_(policy=p, alloc=a, contention=c))
        _same(member.to_np(), want.to_np(), what=f"{p}/{a}/{c}")
        assert member.matches(want, node_maps=True)
        assert member.summary() == want.summary()


def test_mixed_policy_and_strategy_members_with_a_max_events_cut():
    port, ref = _pair(("mesh2d", (8, 8)))
    cases = [(p, a, c) for p, a, c in zip(
        POLICIES, STRATEGIES + STRATEGIES[:2], CONTENTIONS * 3)]
    for cap in (None, 150):
        for member, (p, a, c) in zip(_ensemble(port, cases, cap), cases):
            want = api.run(ref.with_(policy=p, alloc=a, contention=c,
                                     max_events=cap))
            _same(member.to_np(), want.to_np(), what=f"{p}/{a}/{c}/{cap}")


def test_members_that_finish_early_are_frozen():
    """Two tables of unequal length in one machine-mode batch: the short
    member's state stays as its solo run left it."""
    short = dict(TRACE, n_jobs=30)
    port_s, ref_s = _pair(trace=short, capacity=120)
    port_l, ref_l = _pair(capacity=120)
    jobs = [build_jobset(s, device="cpu") for s in (port_s, port_l)]
    res = simulate_ensemble(stack_jobsets(jobs), ["backfill", "bestfit"],
                            [64, 64], machine=build_machine(port_s, "cpu"),
                            alloc_b=["contiguous", "topo"],
                            contention=(1, 5), device="cpu")
    for b, (scn, ref) in enumerate(((port_s, ref_s), (port_l, ref_l))):
        p = "backfill" if b == 0 else "bestfit"
        a = "contiguous" if b == 0 else "topo"
        member = rt.Result(scenario=scn.with_(policy=p, alloc=a,
                                              contention=(1, 5)),
                           raw=res.member(b), jobs=jobs[b])
        want = api.run(ref.with_(policy=p, alloc=a, contention=(1, 5)))
        _same(member.to_np(), want.to_np(), what=p)
    assert res.n_events[0] < res.n_events[1]


@pytest.mark.parametrize("policy,contention", [("backfill", None),
                                               ("backfill", (1, 5)),
                                               ("preempt", (1, 5))])
def test_simulate_alloc_sweep_matches_jax_and_solo_runs(policy, contention):
    port, ref = _pair()
    jobs = build_jobset(port, device="cpu")
    got = rt.simulate_alloc_sweep(jobs, policy, 64, build_machine(port, "cpu"),
                                  contention=contention, device="cpu")
    want = jax_parallel.simulate_alloc_sweep(
        api.build_jobset(ref), api.run.__globals__["engine"].policies_id(
            policy), 64, ref.topology.build(), contention=contention)
    for b, a in enumerate(STRATEGIES):
        member = got.member(b)
        for k in ("start", "finish", "alloc_first", "alloc_span", "alloc_sum",
                  "done"):
            np.testing.assert_array_equal(getattr(member, k).numpy(),
                                          np.asarray(getattr(want, k)[b]),
                                          err_msg=f"{a} {k}")
        n_ev = int(np.asarray(want.n_events)[b])
        assert member.n_events == n_ev
        assert member.makespan == int(np.asarray(want.makespan)[b])
        for k in ("ev_time", "ev_free", "ev_lfb"):
            np.testing.assert_array_equal(
                getattr(member, k).numpy()[:n_ev],
                np.asarray(getattr(want, k)[b])[:n_ev], err_msg=f"{a} {k}")
        solo = rt.run(port.with_(policy=policy, alloc=a,
                                 contention=contention), device="cpu")
        _same(rt.Result(scenario=solo.scenario, raw=member,
                        jobs=jobs).to_np(), solo.to_np(), what=a)


def _sweeps(base_kw, axes, topology=("dragonfly", (8, 8))):
    port, ref = _pair(topology, **base_kw)
    p = rt.sweep(port, axes=axes, device="cpu")
    r = api.sweep(ref, axes=axes)
    assert p.points == r.points
    assert p.n_compiles == r.n_compiles
    for (point, a), (_, b) in zip(p, r):
        _same(a.to_np(), b.to_np(), tuple(b.to_np()), what=str(point))
        assert a.summary() == b.summary()
    return p, r


@pytest.mark.parametrize("policies", (("backfill",), ("fcfs", "preempt"),
                                      ("sjf", "bestfit", "ljf")))
def test_alloc_by_contention_sweep_matches_jax(policies):
    p, _ = _sweeps({}, {"policy": policies, "alloc": STRATEGIES,
                        "contention": CONTENTIONS})
    assert p.n_compiles == 1 and len(p) == 8 * len(policies)
    for point, res in p:
        solo = rt.run(p[0].scenario.with_(**point), device="cpu")
        _same(res.to_np(), solo.to_np(), tuple(solo.to_np()), str(point))


def test_topology_axis_splits_buckets_like_jax():
    topologies = (api.Topology.mesh2d(4, 8), api.Topology.dragonfly(4, 8),
                  api.Topology.linear(32, group_size=4))
    port_topos = tuple(rt.Topology(t.kind, t.shape) for t in topologies)
    port, ref = _pair(("mesh2d", (4, 8)))
    axes = {"alloc": ("contiguous", "topo"), "policy": ("backfill",)}
    p = rt.sweep(port, device="cpu", axes={**axes, "topology": port_topos})
    r = api.sweep(ref, axes={**axes, "topology": topologies})
    assert p.n_compiles == r.n_compiles == 3
    for (point, a), (_, b) in zip(p, r):
        _same(a.to_np(), b.to_np(), tuple(b.to_np()), str(point))


def test_cache_stats_count_like_jax():
    port, ref = _pair(("linear", (16, 4)), trace=dict(TRACE, n_jobs=40))
    rt.reset_cache_stats(clear=True)
    api.reset_cache_stats(clear=True)

    def both(axes):
        rt.sweep(port, axes=axes, device="cpu")
        api.sweep(ref, axes=axes)
        a, b = rt.cache_stats(), api.cache_stats()
        assert (a.compiles, a.hits, a.entries) == (
            b.compiles, b.hits, b.entries), axes
        return a

    assert both({"alloc": ("simple", "topo")}) == rt.SweepCacheStats(1, 0, 1)
    # a new pair of strategies, mixed as before: the same signature
    assert both({"alloc": ("spread", "contiguous")}).hits == 1
    # one strategy for the whole bucket: the reference bakes it in
    assert both({"alloc": ("topo", "topo")}).compiles == 2
    assert both({"contention": (None, (1, 5))}).compiles == 3
    assert both({"contention": ((2, 3), (1, 5))}).hits == 2
    assert both({"policy": ("fcfs", "sjf")}).compiles == 4


def test_ensemble_cap_reads_are_one_a_round():
    """Members under ``contiguous`` read their new largest free runs once
    a round of starts, all of them together."""
    port, _ = _pair()
    cases = [("bestfit", "contiguous", None)] * 3
    engine.reset_counters()
    members = _ensemble(port, cases)
    solo_starts = int(members[0].to_np()["valid"].sum())
    assert engine.counters["cap_reads"] == solo_starts
