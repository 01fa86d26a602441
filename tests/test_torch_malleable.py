"""Malleable jobs in the PyTorch port against the JAX package, on the CPU.

- the model: ``materialize_plan`` equals the reference's array by array,
  and every validation error and overflow guard raises at the reference's
  inputs; ``Scenario(malleable=)`` refuses what the reference's refuses;
- the engine: ``tests/test_malleable.py``'s four differential corners and
  its 12-case grid ({amdahl moldable, power elastic} x {fcfs, sjf,
  backfill} x {scalar, mesh2d with contiguous}) bit for bit against
  ``repro.api.run`` and ``repro.api.run_ref`` (start, finish, n_events,
  every ``mal_*`` column and the summary), elastic jobs composed with node
  failures (failure shrinks, restarts), resizes that fire, backfill at
  ``min_width`` 2-4 with and without failures, and a hypothesis property
  over random curves, width ranges and thresholds;
- the kernel's per-call width column on the plain path;
- rigid runs: the same results, engine counters and selection calls as
  before the slice (``RIGID_BEFORE``, recorded from the parent tree).
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_streams import diff, jax_spec

import repro_torch as rt
from repro import api
from repro.malleable import materialize_plan as jax_materialize

AMDAHL_MOLD = dict(curve="amdahl", param=0.2, min_width=1, max_width=8,
                   mode="moldable")
POWER_ELAST = dict(curve="power", param=0.7, min_width=1, max_width=8,
                   mode="elastic", interval=30, max_ticks=64,
                   shrink_threshold=8, grow_threshold=2, step=2)
CURVES = {"amdahl_mold": AMDAHL_MOLD, "power_elastic": POWER_ELAST}
MAL_COLS = ("mal_width", "mal_nref", "mal_nresize", "mal_node_s", "mal_dur")


def _scenario(mode, policy, mal, n_jobs=100, seed=0, **kw):
    base = dict(trace=rt.SyntheticTrace(n_jobs=n_jobs, seed=seed, congest=4),
                policy=policy, malleable=rt.MalleableModel(**mal))
    if mode == "mesh2d":
        base.update(topology=rt.Topology.mesh2d(4, 8), alloc="contiguous")
    else:
        base.update(total_nodes=32)
    base.update(kw)
    return rt.Scenario(**base)


def assert_bit_exact(scn):
    """The port's run of ``scn`` against ``repro.api.run`` (every column
    and the summary) and ``repro.api.run_ref`` (start, finish, every
    ``mal_*`` column, the other columns it returns, n_events and the
    summary), all exactly."""
    res = rt.run(scn, device="cpu")
    got = res.to_np()
    j = jax_spec(scn)
    want, ref = api.run(j), api.run_ref(j)
    assert diff(got, want.to_np()) == [] and set(got) == set(want.to_np())
    r = ref.to_np()
    keys = [k for k in r if k in got and k not in ("valid", "ev_time",
                                                   "ev_free", "ev_lfb")]
    assert set(MAL_COLS) <= set(keys)
    assert diff(got, r, keys) == []
    assert got["n_events"] == r["n_events"]
    s = res.summary()
    for other in (want.summary(), ref.summary()):
        assert set(s) == set(other)
        for k in s:
            np.testing.assert_allclose(s[k], other[k], rtol=0, atol=0,
                                       err_msg=k)
    return res


# ---------------------------------------------------------------------------
# model and plan
# ---------------------------------------------------------------------------

MESSY = {"submit": np.array([107, 103, 103, 120]),
         "runtime": np.array([50, 0, 9, 31]),
         "nodes": np.array([4, 99, 2, 1]),
         "estimate": np.array([60, 1, 9, 40])}


@pytest.mark.parametrize("model,trace,total,cap", [
    (dict(POWER_ELAST, max_width=6), MESSY, 6, 8),
    (AMDAHL_MOLD, MESSY, 6, None),
    (dict(curve="table", table=(1.0, 0.9, 0.7), min_width=2, max_width=4),
     MESSY, 6, 5),
    (dict(curve="amdahl", param=0.05, max_width=16, mode="elastic",
          interval=64, max_ticks=4096, shrink_threshold=24,
          grow_threshold=4, step=4), "sdsc", 128, 2048),
], ids=("power_elastic", "amdahl_moldable", "table", "sdsc_elastic"))
def test_materialize_plan_equals_jax(model, trace, total, cap):
    if trace == "sdsc":
        trace = rt.SyntheticTrace(n_jobs=2000, seed=13,
                                  kind="sdsc_sp2").materialize()
    got = rt.malleable.materialize_plan(rt.MalleableModel(**model), trace,
                                        total_nodes=total, capacity=cap)
    want = jax_materialize(api.MalleableModel(**model), trace,
                           total_nodes=total, capacity=cap)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert rt.MalleableModel(**model).static_key() == \
        api.MalleableModel(**model).static_key()
    ctx = rt.malleable.make_mal_ctx(got)
    assert ctx.elastic == (model.get("mode") == "elastic")
    assert ctx.n_widths == want.n_widths


BAD_MODELS = [
    (dict(curve="gustafson"), "unknown curve"),
    (dict(curve="amdahl", param=1.5), "serial fraction"),
    (dict(curve="power", param=0.0), "alpha"),
    (dict(curve="table", table=(1.0, 0.9), max_width=8),
     "one efficiency per width"),
    (dict(curve="table", table=(1.0, 1.2), min_width=1, max_width=2),
     "efficiencies"),
    (dict(curve="amdahl", table=(1.0,)), "only meaningful"),
    (dict(min_width=8, max_width=4), "min_width <= max_width"),
    (dict(mode="evolving"), "unknown mode"),
    (dict(mode="elastic", shrink_threshold=2, grow_threshold=2),
     "hysteresis"),
    (dict(mode="elastic", max_ticks=0), "max_ticks"),
    (dict(mode="elastic", interval=0), "interval"),
    (dict(mode="elastic", step=0), "step"),
]


@pytest.mark.parametrize("kw,match", BAD_MODELS,
                         ids=[m for _, m in BAD_MODELS])
def test_model_validation_raises_where_jax_raises(kw, match):
    for mod in (rt, api):
        with pytest.raises(ValueError, match=match):
            mod.MalleableModel(**kw)


_FLAT = dict(curve="amdahl", param=1.0, min_width=1, max_width=1)
INF = 2**30 - 1
GUARDS = [   # (model, trace, total nodes, error or None)
    (_FLAT, {"submit": [0], "runtime": [(INF - 1) // 2], "nodes": [1]}, 1,
     None),
    (_FLAT, {"submit": [0], "runtime": [(INF + 1) // 2], "nodes": [1]}, 1,
     "int32 clock"),
    (dict(_FLAT, max_width=8), {"submit": [0], "runtime": [2**27 - 1],
                                "nodes": [8]}, 8, None),
    (dict(_FLAT, max_width=8), {"submit": [0], "runtime": [2**27],
                                "nodes": [8]}, 8, "node-second"),
    (dict(min_width=4, max_width=8), {"submit": [0], "runtime": [10],
                                      "nodes": [4]}, 2,
     "exceeds the machine"),
]


@pytest.mark.parametrize("model,trace,total,err", GUARDS,
                         ids=("clock_ok", "clock", "node_s_ok", "node_s",
                              "machine"))
def test_plan_guards_raise_at_jax_boundaries(model, trace, total, err):
    for mod, mat in ((rt, rt.malleable.materialize_plan),
                     (api, jax_materialize)):
        if err is None:
            plan = mat(mod.MalleableModel(**model), trace, total_nodes=total)
            assert plan.dur[0, -1] == trace["runtime"][0]
        else:
            with pytest.raises(ValueError, match=err):
                mat(mod.MalleableModel(**model), trace, total_nodes=total)
    with pytest.raises(TypeError, match="mal ctx"):
        rt.malleable.make_mal_ctx((1, 2, 3))


def test_run_just_below_saturation_is_exact():
    scn = rt.Scenario(trace={"submit": [0, 0], "runtime": [2**27 - 5, 100],
                             "nodes": [8, 8]}, total_nodes=8,
                      malleable=rt.MalleableModel(**dict(_FLAT,
                                                         max_width=8)))
    out = assert_bit_exact(scn).to_np()
    assert int(out["finish"][:2].max()) >= 2**27 - 5
    assert (out["finish"][:2] < INF).all()


@pytest.mark.parametrize("case", ("type", "multicluster", "contention",
                                  "preempt"))
def test_scenario_refusals_match_jax(case):
    mold = {"rt": rt.MalleableModel(**AMDAHL_MOLD),
            "api": api.MalleableModel(**AMDAHL_MOLD)}
    for name, mod in (("rt", rt), ("api", api)):
        t = mod.SyntheticTrace(n_jobs=8, seed=0)
        kw = {"type": dict(trace=t, total_nodes=8, malleable="amdahl"),
              "contention": dict(trace=t, topology=mod.Topology.mesh2d(2, 4),
                                 alloc="contiguous", contention=(1, 5),
                                 malleable=mold[name]),
              "preempt": dict(trace=t, total_nodes=8, policy="preempt",
                              malleable=mold[name])}
        if case == "multicluster":
            multi = (api.Multicluster(window=50) if mod is api
                     else object())
            kw[case] = dict(trace=(t, t) if mod is api else t,
                            total_nodes=(8, 8) if mod is api else 8,
                            multicluster=multi, malleable=mold[name])
        err = TypeError if case == "type" else ValueError
        with pytest.raises(err, match={"type": "MalleableModel",
                                       "multicluster": "multicluster",
                                       "contention": "contention",
                                       "preempt": "preempt"}[case]):
            mod.Scenario(**kw[case])


def test_engine_refusals_match_jax():
    jobs = rt.api.build_jobset(rt.Scenario(
        trace=rt.SyntheticTrace(n_jobs=10), total_nodes=8), device="cpu")
    plan = rt.malleable.materialize_plan(
        rt.MalleableModel(**AMDAHL_MOLD),
        rt.SyntheticTrace(n_jobs=10).materialize(), total_nodes=8)
    with pytest.raises(ValueError, match="preempt"):
        rt.simulate(jobs, "preempt", 8, malleable=plan, device="cpu")
    with pytest.raises(ValueError, match="contention"):
        rt.simulate(jobs, "fcfs", 8, machine=rt.Topology.linear(8).build(
            "cpu"), contention=(1, 5), malleable=plan, device="cpu")
    short = rt.malleable.materialize_plan(
        rt.MalleableModel(**AMDAHL_MOLD),
        rt.SyntheticTrace(n_jobs=10).materialize(), total_nodes=8,
        capacity=12)
    with pytest.raises(ValueError, match="plan rows"):
        rt.simulate(jobs, "fcfs", 8, malleable=short, device="cpu")


# ---------------------------------------------------------------------------
# the engine against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,policy,mal", [
    ("scalar", "fcfs", "amdahl_mold"),
    ("scalar", "backfill", "power_elastic"),
    ("mesh2d", "backfill", "amdahl_mold"),
    ("mesh2d", "sjf", "power_elastic"),
], ids=("scalar_fcfs_mold", "scalar_backfill_elastic",
        "mesh_backfill_mold", "mesh_sjf_elastic"))
def test_differential_corner(mode, policy, mal):
    assert_bit_exact(_scenario(mode, policy, CURVES[mal]))


@pytest.mark.parametrize("mal", list(CURVES))
@pytest.mark.parametrize("policy", ("fcfs", "sjf", "backfill"))
@pytest.mark.parametrize("mode", ("scalar", "mesh2d"))
def test_differential_grid(mal, policy, mode):
    assert_bit_exact(_scenario(mode, policy, CURVES[mal]))


@pytest.mark.parametrize("policy", ("ljf", "bestfit"))
def test_other_policies_bit_exact(policy):
    """The per-start loop's other selectors (LJF's head, BestFit's fused
    selection over the width column), elastic on the machine."""
    assert_bit_exact(_scenario("mesh2d", policy, POWER_ELAST))


def test_elastic_resizes_actually_fire():
    res = assert_bit_exact(_scenario("scalar", "backfill", POWER_ELAST))
    assert res.summary()["total_resizes"] > 0
    w = res.to_np()["mal_width"]
    assert w.min() >= 1 and w.max() <= 8


@pytest.mark.parametrize("mode", ("scalar", "mesh2d"))
@pytest.mark.parametrize("requeue", ("requeue", "abort"))
def test_failure_shrink_composes_with_elastic(mode, requeue):
    """Elastic jobs under node failures: a hit on a job with width to give
    sheds the failed node (on a machine that node) instead of dying; the
    rest requeue or abort.  Both engines agree on every width, ledger,
    restart and abort column."""
    res = assert_bit_exact(_scenario(
        mode, "backfill", POWER_ELAST, failures=rt.FailureModel(
            mtbf=400.0, seed=3, mean_repair=50, horizon=4000,
            max_failures=400, requeue=requeue)))
    out = res.to_np()
    assert res.summary()["total_resizes"] > 0
    if requeue == "requeue":
        assert out["n_restarts"].sum() > 0
    else:
        assert out["aborted"].sum() > 0


def test_moldable_requeue_redilates():
    """A moldable job requeued by a failure converts its re-charged
    remaining time to the width of its redispatch."""
    res = assert_bit_exact(_scenario(
        "scalar", "fcfs", AMDAHL_MOLD, failures=rt.FailureModel(
            mtbf=400.0, seed=3, mean_repair=50, horizon=4000,
            max_failures=400)))
    assert res.to_np()["n_restarts"].sum() > 0


# min_width above 1: the dispatch's width offsets, the requeue's reset
# and the failure shrink's "wider than min_width" test all read it
WIDE_ELAST = dict(curve="amdahl", param=0.1, max_width=8, mode="elastic",
                  interval=30, max_ticks=64, shrink_threshold=8,
                  grow_threshold=2, step=2)
WIDE_CASES = {
    "moldable": dict(curve="amdahl", param=0.1, max_width=8,
                     mode="moldable"),
    "elastic": WIDE_ELAST,
    # failures with resize ticks, and with the one tick past the schedule
    # (every resize is then a failure's shrink)
    "elastic_failures": WIDE_ELAST,
    "failure_shrinks_only": dict(WIDE_ELAST, interval=10**6, max_ticks=1),
    "moldable_failures": dict(curve="amdahl", param=0.1, max_width=8,
                              mode="moldable"),
}


def _count_blocked_heads_and_walks(monkeypatch) -> dict:
    """Count the backfill pass's ANY_FIT selections (each one a blocked
    head) and its shadow walks, around the plain path's entries."""
    from repro_torch.core import policies
    from repro_torch.kernels.queue_select import ops, ref
    seen = {"blocked_heads": 0, "walks": 0}
    select, walk = ops.TableSelect.select, policies.shadow_walk

    def counted_select(self, mode, *a, **k):
        seen["blocked_heads"] += mode == ref.ANY_FIT
        return select(self, mode, *a, **k)

    def counted_walk(*a, **k):
        seen["walks"] += 1
        return walk(*a, **k)

    monkeypatch.setattr(ops.TableSelect, "select", counted_select)
    monkeypatch.setattr(policies, "shadow_walk", counted_walk)
    return seen


@pytest.mark.parametrize("case,wlo", [
    ("moldable", 2), ("elastic", 4), ("elastic_failures", 3),
    ("failure_shrinks_only", 2), ("moldable_failures", 3)])
@pytest.mark.parametrize("mode", ("scalar", "mesh2d"))
def test_min_width_above_one_backfill_bit_exact(mode, case, wlo,
                                                monkeypatch):
    """Backfill at ``min_width`` 2-4, bit-exact with ``repro.api.run`` and
    ``run_ref``: moldable choices offset from ``min_width``, resize ticks
    that stop at it, failure shrinks of jobs wider than it, and requeues
    that reset a job to it (a moldable redispatch re-dilating from the
    width of the kill).  Every waiting job asks for the same ``min_width``,
    so a head that does not fit leaves no other job that fits: the pass's
    ANY_FIT test ends it before the shadow walk, as in the reference,
    which is why no malleable run walks."""
    from repro_torch.core import engine
    seen = _count_blocked_heads_and_walks(monkeypatch)
    engine.reset_counters()
    kw = {}
    if case.endswith("failures") or case == "failure_shrinks_only":
        kw["failures"] = rt.FailureModel(mtbf=400.0, seed=3, mean_repair=50,
                                         horizon=4000, max_failures=400)
    res = assert_bit_exact(_scenario(
        mode, "backfill", dict(WIDE_CASES[case], min_width=wlo), **kw))
    out = res.to_np()
    w = out["mal_width"][out["valid"]]
    assert w.min() >= wlo and w.max() <= 8
    assert seen["blocked_heads"] > 0 and seen["walks"] == 0
    if "failures" in kw:
        assert out["n_restarts"].sum() > 0
    if WIDE_CASES[case]["mode"] == "elastic":
        assert out["mal_nresize"].sum() > 0
    if case == "failure_shrinks_only":
        assert engine.counters["resize_ticks"] == 0


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**16),
       curve=st.sampled_from(("amdahl", "power")),
       param=st.floats(0.05, 0.95),
       wlo=st.integers(1, 3), whi=st.integers(2, 8),
       grow=st.integers(0, 2), shrink_delta=st.integers(1, 8),
       step=st.integers(1, 3),
       mal_mode=st.sampled_from(("moldable", "elastic")),
       policy=st.sampled_from(("fcfs", "sjf", "backfill")),
       mode=st.sampled_from(("scalar", "mesh2d")))
def test_random_curves_engines_bit_exact(seed, curve, param, wlo, whi,
                                         grow, shrink_delta, step, mal_mode,
                                         policy, mode):
    whi = max(whi, wlo)
    mal = dict(curve=curve, param=param, min_width=wlo, max_width=whi,
               mode=mal_mode, interval=25, max_ticks=64,
               shrink_threshold=grow + shrink_delta, grow_threshold=grow,
               step=step)
    out = assert_bit_exact(
        _scenario(mode, policy, mal, n_jobs=60, seed=seed)).to_np()
    done = out["valid"] & out["done"]
    w = out["mal_width"][done]
    if len(w):
        assert w.min() >= wlo and w.max() <= whi


# ---------------------------------------------------------------------------
# the per-call width column of the kernel's plain path
# ---------------------------------------------------------------------------


def test_per_call_width_column_on_the_plain_path():
    """``TableSelect.select``, ``shadow_walk`` and the batched entries read
    a per-call ``nodes`` column in place of the bound one, on the CPU as
    the kernel does on the card; without it they read the bound one."""
    from repro_torch.kernels.queue_select import ops, ref
    g = torch.Generator().manual_seed(0)
    n = 64
    cols = {"submit": torch.arange(n, dtype=torch.int32),
            "estimate": torch.randint(1, 50, (n,), generator=g,
                                      dtype=torch.int32),
            "nodes": torch.randint(1, 16, (n,), generator=g,
                                   dtype=torch.int32),
            "priority": torch.zeros(n, dtype=torch.int32)}
    jstate = torch.randint(1, 3, (n,), generator=g, dtype=torch.int32)
    rsv = torch.randint(10, 90, (n,), generator=g, dtype=torch.int32)
    width = torch.randint(1, 4, (n,), generator=g, dtype=torch.int32)
    table = ops.TableSelect(cols)
    p = dict(clock=5, free=3, cap=3, shadow=40, extra=1, exclude=0)
    for mode in (ref.BESTFIT, ref.ANY_FIT, ref.BACKFILL_CAND):
        want = ref.fused_select_reference(mode, {**cols, "nodes": width},
                                          jstate, **p)
        assert table.select(mode, jstate, **p, nodes=width) == want
        assert table.select(mode, jstate, **p) == \
            ref.fused_select_reference(mode, cols, jstate, **p)
    assert ops.shadow_walk(table, jstate, rsv, 5, 3, 20, nodes=width) == \
        ref.shadow_walk_reference(width, jstate, rsv, 5, 3, 20)
    assert ops.shadow_walk(table, jstate, rsv, 5, 3, 20) == \
        ref.shadow_walk_reference(cols["nodes"], jstate, rsv, 5, 3, 20)
    stacked = ops.BatchedTableSelect({c: torch.stack([t, t.flip(0)])
                                      for c, t in cols.items()})
    js2, rsv2 = torch.stack([jstate, jstate]), torch.stack([rsv, rsv])
    w2 = torch.stack([width, width.flip(0)])
    got = stacked.select_batch([(1, ref.BESTFIT, ref.params(free=3, cap=3))],
                               js2, nodes=w2)
    assert got == [ref.fused_select_reference(
        ref.BESTFIT, {c: t.flip(0) for c, t in cols.items()} | {
            "nodes": width.flip(0)}, jstate, free=3, cap=3)]
    got = stacked.walk_batch([(0, ref.params(clock=5, free=3,
                                             head_need=20))],
                             js2, rsv2, nodes=w2)
    assert got == [ref.shadow_walk_reference(width, jstate, rsv, 5, 3, 20)]


# ---------------------------------------------------------------------------
# rigid runs pay nothing
# ---------------------------------------------------------------------------

def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<i4").tobytes()
                          ).hexdigest()[:16]


def _rigid_scenarios():
    sdsc = rt.SyntheticTrace(n_jobs=300, seed=1, kind="sdsc_sp2", congest=4)
    base = rt.Scenario(trace=sdsc, total_nodes=64, policy="backfill")
    mesh = dict(total_nodes=None, topology=rt.Topology.mesh2d(8, 8))
    return {
        "backfill": base,
        "fcfs": base.with_(policy="fcfs"),
        "bestfit": base.with_(policy="bestfit"),
        "mesh_sjf_contiguous": base.with_(policy="sjf", alloc="contiguous",
                                          **mesh),
        "mesh_backfill_spread": base.with_(alloc="spread", **mesh),
        "failures": base.with_(failures=rt.FailureModel(
            mtbf=20e3, seed=3, mean_repair=600, horizon=2**17,
            max_failures=512)),
        "dag_fcfs": rt.Scenario(trace=rt.WorkflowTrace(
            kind="galactic", params=(("tiles", 4),)), total_nodes=64),
    }


def rigid_probe() -> dict:
    """Each rigid scenario's digests, engine counters and the selection and
    walk calls it made (counted around the plain path's entries), solo and
    as one sweep of three policies on two machine sizes."""
    from repro_torch.core import engine, policies
    from repro_torch.kernels.queue_select import ops
    calls = {}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrap

    saved = (ops.TableSelect.select, policies.shadow_walk,
             ops.BatchedTableSelect.select_batch,
             ops.BatchedTableSelect.walk_batch)
    ops.TableSelect.select = counted("select", saved[0])
    policies.shadow_walk = counted("walk", saved[1])
    ops.BatchedTableSelect.select_batch = counted("select_batch", saved[2])
    ops.BatchedTableSelect.walk_batch = counted("walk_batch", saved[3])
    out = {}
    try:
        runs = [(n, s, None) for n, s in _rigid_scenarios().items()]
        runs.append(("sweep", _rigid_scenarios()["backfill"], {
            "policy": ("fcfs", "backfill", "bestfit"),
            "total_nodes": (64, 96)}))
        for name, scn, axes in runs:
            calls.clear()
            engine.reset_counters()
            if axes is None:
                results = [rt.run(scn, device="cpu")]
            else:
                results = rt.sweep(scn, axes=axes, device="cpu").results
            e = {"calls": dict(sorted(calls.items())),
                 "counters": dict(engine.counters), "runs": []}
            for r in results:
                o = r.to_np()
                assert not any(k.startswith("mal_") for k in o)
                assert getattr(r.raw, "mal", None) is None
                e["runs"].append([int(o["n_events"]), _digest(o["start"]),
                                  _digest(o["finish"])] + [
                    _digest(o[k]) for k in ("alloc_first", "alloc_sum",
                                            "ev_lfb") if k in o])
            out[name] = e
    finally:
        (ops.TableSelect.select, policies.shadow_walk,
         ops.BatchedTableSelect.select_batch,
         ops.BatchedTableSelect.walk_batch) = saved
    return out


RIGID_BEFORE = json.loads(r"""
{"backfill":{"calls":{"select":1681,"walk":203},"counters":{"aborts":0,
"cap_reads":0,"failures":0,"max_walks_per_event":1,"redo":0,"repairs":0,
"requeues":0,"stream_reads":0,"ticks":0},"runs":[[592,"0b67063ebccfcc39",
"2fee6be0872f1864"]]},"bestfit":{"calls":{"select":894},
"counters":{"aborts":0,"cap_reads":0,"failures":0,"max_walks_per_event":0,
"redo":0,"repairs":0,"requeues":0,"stream_reads":0,"ticks":0},"runs":[[594,
"a395e51285f24de5","737832b6676d511f"]]},"dag_fcfs":{"calls":{},
"counters":{"aborts":0,"cap_reads":0,"failures":0,"max_walks_per_event":0,
"redo":0,"repairs":0,"requeues":0,"stream_reads":0,"ticks":0},"runs":[[74,
"f712499e30bb8207","d65516620ea705c1"]]},"failures":{"calls":{"select":3950,
"walk":443},"counters":{"aborts":0,"cap_reads":0,"failures":418,
"max_walks_per_event":1,"redo":0,"repairs":418,"requeues":362,
"stream_reads":418,"ticks":0},"runs":[[1426,"d7c7589f62a92f14",
"c45e7eb2d5387567"]]},"fcfs":{"calls":{"select":894},"counters":{"aborts":0,
"cap_reads":0,"failures":0,"max_walks_per_event":0,"redo":0,"repairs":0,
"requeues":0,"stream_reads":0,"ticks":0},"runs":[[594,"2a7011a12a8f2b8a",
"c17cbe530bcec6bf"]]},"mesh_backfill_spread":{"calls":{"select":1681,
"walk":203},"counters":{"aborts":0,"cap_reads":0,"failures":0,
"max_walks_per_event":1,"redo":0,"repairs":0,"requeues":0,"stream_reads":0,
"ticks":0},"runs":[[592,"0b67063ebccfcc39","2fee6be0872f1864",
"c652a168475470d2","38d40507e2092035","faebbcf36f427219"]]},
"mesh_sjf_contiguous":{"calls":{"select":894},"counters":{"aborts":0,
"cap_reads":300,"failures":0,"max_walks_per_event":0,"redo":0,"repairs":0,
"requeues":0,"stream_reads":0,"ticks":0},"runs":[[594,"61be4c52bdab42c9",
"ffbeb75a446132e8","1645752dd56bf08c","8d95ab40fa52764e",
"b4c8c33d1b1e12dc"]]},"sweep":{"calls":{"select_batch":2474,
"walk_batch":366},"counters":{"aborts":0,"cap_reads":0,"failures":0,
"max_walks_per_event":1,"redo":0,"repairs":0,"requeues":0,"stream_reads":0,
"ticks":0},"runs":[[594,"2a7011a12a8f2b8a","c17cbe530bcec6bf"],[593,
"14d9d7a87b77ce17","ff6a3d253ba4e62c"],[592,"0b67063ebccfcc39",
"2fee6be0872f1864"],[591,"5c26c529f067bc5a","2c41da09e34712a0"],[594,
"a395e51285f24de5","737832b6676d511f"],[594,"66b73aa20554b497",
"235a8262259bc011"]]}}
""")


@pytest.mark.parametrize("name", list(RIGID_BEFORE) or ["none"])
def test_rigid_run_unchanged_by_the_slice(name):
    """A rigid run (``malleable=None``) gives the results, engine counters
    and selection calls it gave before malleable jobs came: the same
    digests and counts as the parent tree's (``RIGID_BEFORE``).  The new
    counters stay 0."""
    got = _rigid_probe_cached()[name]
    want = RIGID_BEFORE[name]
    assert got["runs"] == want["runs"]
    assert got["calls"] == want["calls"]
    for k, v in got["counters"].items():
        assert v == want["counters"].get(k, 0), k


_PROBE = {}


def _rigid_probe_cached() -> dict:
    if not _PROBE:
        _PROBE.update(rigid_probe())
    return _PROBE


if __name__ == "__main__":
    # print the probe of the tree on the path (RIGID_BEFORE's source)
    print(json.dumps(rigid_probe(), indent=1, sort_keys=True))
