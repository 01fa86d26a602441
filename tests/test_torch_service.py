"""The PyTorch port's what-if service against the JAX package's
(``tests/test_service.py`` mirrored on ``repro_torch.service``, on the CPU).

Every answer of the port's planner must equal the JAX planner's on the
same fleet and query, byte for byte in ``canonical_dumps`` but for the
process's ``cache.entries`` counter; the compile and hit deltas of a
cold pass are compared too.  Every evaluated point must equal the port's
``run`` and ``run_ref`` of its ``apply_delta`` scenario.  Also held to the
reference: the placement semantics, the counts of repeated and
bucket-splitting queries, the codec's round trips and its structured
errors (codes and messages), the fleet codec, and the HTTP front end
(``python -m repro_torch.service --demo --device cpu`` in a subprocess).
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st
from _torch_streams import jax_spec

import repro_torch as rt
from repro import api
from repro import service as jsvc
from repro_torch import service
from repro_torch.service import (
    CapacityPlanner, JobRequest, Objective, ScenarioDelta, SchemaError,
    WhatIfQuery, apply_delta, canonical_dumps,
)

SUBPROC_TIMEOUT = 240
ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(os.path.dirname(__file__), "data",
                    "whatif_queries_v1.json")


def base_scenario(policy="fcfs", topo=False, failures=False, n_jobs=50,
                  seed=0):
    kw = {}
    if topo:
        kw.update(topology=rt.Topology.mesh2d(4, 8), alloc="contiguous")
    else:
        kw.update(total_nodes=32)
    if failures:
        kw.update(failures=rt.FailureModel(mtbf=300_000.0, seed=3,
                                           max_failures=64))
    return rt.Scenario(trace=rt.SyntheticTrace(n_jobs=n_jobs, seed=seed,
                                               kind="sdsc_sp2"),
                       policy=policy, **kw)


def planners(fleet):
    """The port's planner (on the CPU) and the JAX planner of the same
    fleet."""
    return (CapacityPlanner(fleet, device="cpu"),
            jsvc.CapacityPlanner({k: jax_spec(v) for k, v in fleet.items()}))


def as_jax(query):
    return jsvc.WhatIfQuery.from_json(query.to_json())


def without_entries(answer) -> str:
    answer = json.loads(canonical_dumps(answer))
    answer["cache"].pop("entries")
    return canonical_dumps(answer)


def without_cache(answer) -> dict:
    answer = json.loads(canonical_dumps(answer))
    answer.pop("cache")
    return answer


def assert_same_answer(port, ref, query, *, cold=True):
    """Both planners' answers to ``query``, equal byte for byte but for
    ``cache.entries``; with ``cold`` both caches are cleared first, so
    the compile and hit deltas compare too."""
    if cold:
        rt.reset_cache_stats(clear=True)
        api.reset_cache_stats(clear=True)
    got, want = port.answer(query), ref.answer(as_jax(query))
    assert without_entries(got) == without_entries(want), query.kind
    return got


def assert_differential(planner, query, fleet):
    """Every evaluated point equals the port's run() and run_ref() of the
    independently lowered scenario."""
    points = planner.evaluate(query)
    assert points
    for p in points:
        if p.get("infeasible"):
            continue
        scn = p["scenario"]
        direct = rt.run(scn, device="cpu")
        assert p["result"].matches(direct), p["label"]
        assert direct.matches(rt.run_ref(scn)), p["label"]
        assert p["result"].to_np()["n_events"] == direct.to_np()["n_events"]
        if p.get("delta") is not None:
            assert apply_delta(fleet[p["queue"]], p["delta"]) == scn
    return points


# ---------------------------------------------------------------------------
# differential harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["fcfs", "sjf", "backfill"])
@pytest.mark.parametrize("topo", [False, True])
@pytest.mark.parametrize("failures", [False, True])
def test_differential_grid(policy, topo, failures):
    """Every query family, equal to the JAX planner's answer and each point
    bit-exact vs run()+run_ref(), across {fcfs, sjf, backfill} x {scalar,
    mesh2d+contiguous} x {failures}."""
    base = base_scenario(policy, topo=topo, failures=failures)
    fleet = {"q": base}
    port, ref = planners(fleet)

    job = JobRequest(submit=50, runtime=400, nodes=8)
    queries = [WhatIfQuery(kind="placement", job=job)]
    deltas = [ScenarioDelta(), ScenarioDelta(policy="fcfs"),
              ScenarioDelta(inject=(job, JobRequest(submit=0, runtime=100,
                                                    nodes=4)))]
    if topo:
        deltas.append(ScenarioDelta(alloc="simple"))
    else:
        deltas.append(ScenarioDelta(add_nodes=32))
    if failures:
        deltas.append(ScenarioDelta(mtbf=150_000.0,
                                    checkpoint_interval=500))
    queries.append(WhatIfQuery(kind="capacity", queue="q",
                               deltas=tuple(deltas)))
    if failures:
        queries.append(WhatIfQuery(kind="reliability", queue="q",
                                   mtbf_grid=(100_000.0, 300_000.0),
                                   checkpoint_grid=(0, 800)))
    for q in queries:
        assert_same_answer(port, ref, q)
        pts = assert_differential(port, q, fleet)
        if q.kind == "capacity":
            assert len(pts) == len(deltas)


def test_differential_fast_corner():
    """Batched add_nodes grid + candidate injection on a scalar backfill
    queue with failures."""
    fleet = {"q": base_scenario("backfill", failures=True, n_jobs=40)}
    port, ref = planners(fleet)
    q = WhatIfQuery(
        kind="capacity", queue="q",
        deltas=(ScenarioDelta(), ScenarioDelta(add_nodes=16),
                ScenarioDelta(add_nodes=-8),
                ScenarioDelta(inject=(JobRequest(submit=10, runtime=200,
                                                 nodes=6),))))
    ans = assert_same_answer(port, ref, q)
    pts = assert_differential(port, q, fleet)
    assert [p["label"] for p in ans["points"]] == [p["label"] for p in pts]
    assert ans["recommendations"][0]["rank"] == 1
    assert ans["recommended"] == ans["recommendations"][0]["label"]
    for rec in ans["recommendations"]:
        assert rec["delta"] == pytest.approx(
            rec["value"] - rec["baseline"], nan_ok=True)


def test_placement_candidate_semantics():
    """The candidate lands at the lexsort position (behind equal-submit
    incumbents), and its reported wait is its own row's wait in the
    direct run."""
    fleet = {"small": base_scenario("fcfs", n_jobs=30),
             "big": base_scenario("fcfs", n_jobs=30, seed=1).with_(
                 total_nodes=64)}
    port, ref = planners(fleet)
    job = JobRequest(submit=0, runtime=300, nodes=8)
    ans = assert_same_answer(port, ref, WhatIfQuery(kind="placement",
                                                    job=job))
    assert set(p["queue"] for p in ans["points"]) == {"small", "big"}
    for p in ans["points"]:
        scn = apply_delta(fleet[p["queue"]], ScenarioDelta(inject=(job,)))
        direct = rt.run(scn, device="cpu").to_np()
        row = p["candidate"]["row"]
        assert p["candidate"]["wait"] == int(direct["wait"][row])
        sub = scn.trace.materialize()["submit"]
        assert row == int(np.sum(np.asarray(sub) <= job.submit) - 1)
    assert ans["recommended"] in ("small", "big")
    # a submit before the trace's first would re-zero every incumbent
    with pytest.raises(SchemaError):
        JobRequest(submit=-1, runtime=10, nodes=1)


def test_placement_infeasible_queue_excluded():
    fleet = {"small": base_scenario(n_jobs=20),
             "big": base_scenario(n_jobs=20).with_(total_nodes=256)}
    port, ref = planners(fleet)
    q = WhatIfQuery(kind="placement",
                    job=JobRequest(submit=0, runtime=50, nodes=100))
    ans = assert_same_answer(port, ref, q)
    by_queue = {p["queue"]: p for p in ans["points"]}
    assert "infeasible" in by_queue["small"]
    assert ans["recommended"] == "big"
    # every queue too small => the same structured error, not a clamped
    # answer
    q = WhatIfQuery(kind="placement",
                    job=JobRequest(submit=0, runtime=50, nodes=9999))
    with pytest.raises(SchemaError) as got:
        port.answer(q)
    with pytest.raises(jsvc.SchemaError) as want:
        ref.answer(as_jax(q))
    assert (got.value.code, str(got.value)) == (want.value.code,
                                                str(want.value))


def test_nan_answers_become_null():
    """A candidate that never starts (its queue's event cap reached before
    it) reports ``candidate_wait`` null, and an empty percentile is null,
    as the reference's are."""
    base = base_scenario("fcfs", n_jobs=30).with_(max_events=12)
    fleet = {"q": base}
    port, ref = planners(fleet)
    q = WhatIfQuery(kind="placement",
                    job=JobRequest(submit=10**6, runtime=50, nodes=4))
    ans = assert_same_answer(port, ref, q)
    (point,) = ans["points"]
    assert point["candidate"]["started"] is False
    assert point["summary"]["candidate_wait"] is None
    assert ans["recommendations"][0]["value"] is None
    # a queue where no job finishes: an empty p99 is null, not a 500
    port, ref = planners({"q": base.with_(max_events=1)})
    ans = assert_same_answer(port, ref, WhatIfQuery(
        kind="capacity", queue="q", deltas=(ScenarioDelta(),
                                            ScenarioDelta(add_nodes=8))))
    assert ans["baseline"]["p99_wait"] is None
    assert [r["value"] for r in ans["recommendations"]] == [None, None]


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@given(st.data())
@settings(max_examples=15, deadline=None)
def test_random_delta_differential(data):
    """Property: any valid delta stays bit-exact vs the port's run() and
    run_ref() and the JAX package's run_ref(), on the cold path (fresh
    planner) and the warm path (second evaluation)."""
    base = base_scenario(
        policy=data.draw(st.sampled_from(["fcfs", "sjf", "backfill"])),
        failures=data.draw(st.booleans()), n_jobs=30,
        seed=data.draw(st.integers(0, 3)))
    inject = tuple(
        JobRequest(submit=data.draw(st.integers(0, 1000)),
                   runtime=data.draw(st.integers(1, 500)),
                   nodes=data.draw(st.integers(1, 32)))
        for _ in range(data.draw(st.integers(0, 2))))
    delta = ScenarioDelta(
        add_nodes=data.draw(st.integers(-16, 64)),
        policy=data.draw(st.sampled_from(
            [None, "fcfs", "sjf", "backfill"])),
        mtbf=(data.draw(st.floats(50_000, 500_000))
              if base.failures is not None and data.draw(st.booleans())
              else None),
        inject=inject)
    planner = CapacityPlanner({"q": base}, device="cpu")
    query = WhatIfQuery(kind="capacity", queue="q", deltas=(delta,))
    ref = api.run_ref(jax_spec(apply_delta(base, delta)))
    for attempt in ("cold", "warm"):
        pts = planner.evaluate(query)
        scn = pts[0]["scenario"]
        assert scn == apply_delta(base, delta)
        direct = rt.run(scn, device="cpu")
        assert pts[0]["result"].matches(direct), attempt
        assert direct.matches(rt.run_ref(scn)), attempt
        assert direct.matches(ref), attempt


# ---------------------------------------------------------------------------
# cache counts (the bucket-signature contract), equal to the reference's
# ---------------------------------------------------------------------------


def _counts(port, ref, query):
    a = port.answer(query)["cache"]
    b = ref.answer(as_jax(query))["cache"]
    assert (a["compiles"], a["hits"]) == (b["compiles"], b["hits"]), (
        query.kind, a, b)
    return a["compiles"], a["hits"]


def _reset(clear=False):
    rt.reset_cache_stats(clear=clear)
    api.reset_cache_stats(clear=clear)


def test_repeated_queries_compile_once():
    """Same-bucket queries count one compile: the first answer is the only
    cold execution, every repeat (different candidate values, same
    shapes) is a hit, in both packages."""
    port, ref = planners({"q": base_scenario("backfill", n_jobs=40)})
    q1 = WhatIfQuery(kind="placement",
                     job=JobRequest(submit=0, runtime=100, nodes=4))
    _reset(clear=True)
    port.fleet_status()
    ref.fleet_status()
    _reset()
    assert _counts(port, ref, q1) == (1, 0)
    for submit, runtime, nodes in ((50, 700, 16), (999, 1, 1)):
        assert _counts(port, ref, WhatIfQuery(
            kind="placement", job=JobRequest(
                submit=submit, runtime=runtime, nodes=nodes))) == (0, 1)


def test_bucket_splitting_deltas():
    """Deltas that change the bucket signature split buckets exactly as
    the reference's static keys predict; data deltas do not."""
    port, ref = planners({"q": base_scenario("fcfs", n_jobs=40)})
    job = JobRequest(submit=0, runtime=100, nodes=4)
    _reset(clear=True)
    port.fleet_status()
    ref.fleet_status()
    _reset()
    # policy swap: the policy is part of the signature -> 2 compiles
    assert _counts(port, ref, WhatIfQuery(
        kind="capacity", queue="q",
        deltas=(ScenarioDelta(inject=(job,)),
                ScenarioDelta(policy="sjf", inject=(job,)))))[0] == 2
    # the injected count splits the table's shape: 1 job vs 2 jobs -> a
    # new compile; repeating either count is warm
    _reset()
    one = WhatIfQuery(kind="capacity", queue="q",
                      deltas=(ScenarioDelta(inject=(job,)),))
    two = WhatIfQuery(kind="capacity", queue="q",
                      deltas=(ScenarioDelta(inject=(job, job)),))
    assert _counts(port, ref, one) == (0, 1)
    assert _counts(port, ref, two) == (1, 0)
    assert _counts(port, ref, two) == (0, 1)
    # a batched add_nodes grid on a scalar queue is ONE bucket
    _reset()
    grid = WhatIfQuery(kind="capacity", queue="q",
                       deltas=tuple(ScenarioDelta(add_nodes=d)
                                    for d in (0, 16, 32, 64)))
    assert _counts(port, ref, grid) == (1, 0)
    assert _counts(port, ref, grid) == (0, 1)


def test_bucket_splitting_on_a_machine():
    """Policies on a machine and alloc swaps each need their own bucket,
    in both packages."""
    port, ref = planners({"m": base_scenario("sjf", topo=True, n_jobs=30)})
    _reset(clear=True)
    q = WhatIfQuery(kind="capacity", queue="m", deltas=(
        ScenarioDelta(), ScenarioDelta(policy="fcfs"),
        ScenarioDelta(alloc="simple"), ScenarioDelta(alloc="spread"),
        ScenarioDelta(alloc="simple", policy="fcfs")))
    # five signatures; the baseline is the identity delta's, a hit
    assert _counts(port, ref, q) == (5, 1)
    assert _counts(port, ref, q) == (0, 5)   # the baseline is cached


def test_reset_cache_stats_clear_goes_cold():
    port, ref = planners({"q": base_scenario(n_jobs=30)})
    q = WhatIfQuery(kind="placement",
                    job=JobRequest(submit=0, runtime=10, nodes=1))
    port.answer(q)
    ref.answer(as_jax(q))
    _reset(clear=True)
    assert rt.cache_stats() == rt.SweepCacheStats(0, 0, 0)
    assert _counts(port, ref, q) == (1, 0)


# ---------------------------------------------------------------------------
# JSON round trips, the fixture's queries, structured errors
# ---------------------------------------------------------------------------


def _fixture():
    with open(DATA, "r", encoding="utf-8") as f:
        return json.load(f)


def test_golden_fixture_round_trips_byte_identical():
    doc = _fixture()
    assert doc["version"] == service.SCHEMA_VERSION == jsvc.SCHEMA_VERSION
    kinds = set()
    for entry in doc["queries"]:
        text = canonical_dumps(entry)
        q = WhatIfQuery.from_json(text)
        kinds.add(q.kind)
        assert q.to_json() == text
        assert WhatIfQuery.from_json(q.to_json()).to_json() == text
        assert jsvc.WhatIfQuery.from_json(text).to_json() == text
        assert q.default_objective().to_json_dict() == jsvc.WhatIfQuery \
            .from_json(text).default_objective().to_json_dict()
    assert kinds == {"placement", "capacity", "reliability"}


@pytest.mark.parametrize("index", range(3))
def test_fixture_queries_answer_like_jax(index):
    """The fixture's queries (a candidate with estimate and priority over
    two queues; nodes, policy and injection deltas against a target; an
    MTBF x checkpoint grid) on the demo fleet, equal to the JAX planner's
    answers."""
    query = WhatIfQuery.from_json_dict(_fixture()["queries"][index])
    fleet = service.demo_fleet()
    port = CapacityPlanner(fleet, device="cpu")
    ref = jsvc.CapacityPlanner(jsvc.demo_fleet())
    got = assert_same_answer(port, ref, query)
    assert got["recommended"] is not None or query.kind == "capacity"
    assert_differential(port, query, fleet)


BAD_QUERIES = {
    "unknown_field": {"version": 1, "kind": "capacity", "frobnicate": 1},
    "missing_version": {"kind": "capacity"},
    "bad_version": {"version": 99, "kind": "capacity"},
    "kind_not_str": {"version": 1, "kind": 3},
    "bad_kind": {"version": 1, "kind": "??"},
    "queues_not_list": {"version": 1, "kind": "placement", "queues": "a"},
    "queue_not_str": {"version": 1, "kind": "capacity", "queue": 5},
    "deltas_not_list": {"version": 1, "kind": "capacity", "deltas": {}},
    "mtbf_not_numbers": {"version": 1, "kind": "reliability",
                         "mtbf_grid": [True]},
    "ckpt_not_ints": {"version": 1, "kind": "reliability",
                      "mtbf_grid": [1.0], "checkpoint_grid": [1.5]},
    "no_deltas": {"version": 1, "kind": "capacity", "deltas": []},
    "placement_no_job": {"version": 1, "kind": "placement"},
    "placement_with_deltas": {
        "version": 1, "kind": "placement", "deltas": [{}],
        "job": {"submit": 0, "runtime": 1, "nodes": 1}},
    "capacity_with_job": {
        "version": 1, "kind": "capacity", "deltas": [{}],
        "job": {"submit": 0, "runtime": 1, "nodes": 1}},
    "reliability_no_grid": {"version": 1, "kind": "reliability"},
    "reliability_with_deltas": {"version": 1, "kind": "reliability",
                                "mtbf_grid": [1.0], "deltas": [{}]},
    "job_unknown_field": {"version": 1, "kind": "placement",
                          "job": {"submit": 0, "runtime": 1, "nodes": 1,
                                  "x": 0}},
    "job_missing_nodes": {"version": 1, "kind": "placement",
                          "job": {"submit": 0, "runtime": 1}},
    "job_not_number": {"version": 1, "kind": "placement",
                       "job": {"submit": "0", "runtime": 1, "nodes": 1}},
    "job_bad_runtime": {"version": 1, "kind": "placement",
                        "job": {"submit": 0, "runtime": 0, "nodes": 1}},
    "delta_unknown_field": {"version": 1, "kind": "capacity",
                            "deltas": [{"nonsense": True}]},
    "delta_inject_not_list": {"version": 1, "kind": "capacity",
                              "deltas": [{"inject": "x"}]},
    "delta_policy_not_str": {"version": 1, "kind": "capacity",
                             "deltas": [{"policy": 1}]},
    "delta_bad_mtbf": {"version": 1, "kind": "capacity",
                       "deltas": [{"mtbf": -1}]},
    "delta_bad_ckpt": {"version": 1, "kind": "capacity",
                       "deltas": [{"checkpoint_interval": -1}]},
    "objective_bad_goal": {"version": 1, "kind": "capacity",
                           "deltas": [{}], "objective": {"goal": "up"}},
    "objective_not_str": {"version": 1, "kind": "capacity",
                          "deltas": [{}], "objective": {"metric": 1}},
    "objective_unknown_field": {"version": 1, "kind": "capacity",
                                "deltas": [{}], "objective": {"x": 1}},
    "not_an_object": [],
}


@pytest.mark.parametrize("case", sorted(BAD_QUERIES))
def test_query_codec_errors_match_jax(case):
    doc = BAD_QUERIES[case]
    with pytest.raises(jsvc.SchemaError) as want:
        jsvc.WhatIfQuery.from_json_dict(doc)
    with pytest.raises(SchemaError) as got:
        WhatIfQuery.from_json_dict(doc)
    assert (got.value.code, str(got.value)) == (want.value.code,
                                                str(want.value))


def test_query_text_errors_match_jax():
    for text in ("not json at all {", '{"version": 1, "kind": ', "[1, 2"):
        with pytest.raises(jsvc.SchemaError) as want:
            jsvc.WhatIfQuery.from_json(text)
        with pytest.raises(SchemaError) as got:
            WhatIfQuery.from_json(text)
        assert (got.value.code, str(got.value)) == (want.value.code,
                                                    str(want.value))


APPLY_ERRORS = {
    "mtbf_without_failures": (dict(), dict(mtbf=1000.0)),
    "ckpt_without_failures": (dict(), dict(checkpoint_interval=5)),
    "alloc_without_topology": (dict(), dict(alloc="contiguous")),
    "shrink_to_zero": (dict(), dict(add_nodes=-32)),
    "mesh_growth": (dict(topo=True), dict(add_nodes=16)),
}


@pytest.mark.parametrize("case", sorted(APPLY_ERRORS))
def test_apply_delta_structured_errors(case):
    base_kw, delta_kw = APPLY_ERRORS[case]
    base = base_scenario(**base_kw)
    with pytest.raises(jsvc.SchemaError) as want:
        jsvc.apply_delta(jax_spec(base), jsvc.ScenarioDelta(**delta_kw))
    with pytest.raises(SchemaError) as got:
        apply_delta(base, ScenarioDelta(**delta_kw))
    assert (got.value.code, str(got.value)) == (want.value.code,
                                                str(want.value))


def test_apply_delta_on_a_linear_machine_and_injected_base():
    base = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=10),
                       topology=rt.Topology.linear(16), policy="fcfs")
    for delta in (ScenarioDelta(add_nodes=8), ScenarioDelta(add_nodes=-15)):
        got = apply_delta(base, delta)
        want = jsvc.apply_delta(jax_spec(base), as_jax_delta(delta))
        assert service.scenario_to_json(got) == jsvc.scenario_to_json(want)
    with pytest.raises(SchemaError) as got:
        apply_delta(base, ScenarioDelta(add_nodes=-16))
    with pytest.raises(jsvc.SchemaError) as want:
        jsvc.apply_delta(jax_spec(base), jsvc.ScenarioDelta(add_nodes=-16))
    assert str(got.value) == str(want.value)
    job = JobRequest(submit=1, runtime=2, nodes=3)
    twice = apply_delta(apply_delta(base, ScenarioDelta(inject=(job,))),
                        ScenarioDelta(inject=(job,)))
    assert twice.trace.jobs == (job.as_tuple(),) * 2
    assert isinstance(twice.trace.base, rt.SyntheticTrace)


def as_jax_delta(delta):
    return jsvc.ScenarioDelta.from_json_dict(delta.to_json_dict())


def test_planner_errors_match_jax():
    fleet = {"a": base_scenario(n_jobs=10), "b": base_scenario(n_jobs=10)}
    port, ref = planners(fleet)
    cases = [
        WhatIfQuery(kind="capacity", queue="nope", deltas=(ScenarioDelta(),)),
        WhatIfQuery(kind="capacity", deltas=(ScenarioDelta(),)),
        WhatIfQuery(kind="reliability", queue="a", mtbf_grid=(1e6,)),
        WhatIfQuery(kind="capacity", queue="a", deltas=(ScenarioDelta(),),
                    objective=Objective(metric="nonsense")),
    ]
    for q in cases:
        with pytest.raises(Exception) as want:
            ref.answer(as_jax(q))
        with pytest.raises(Exception) as got:
            port.answer(q)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)
        assert getattr(got.value, "code", None) == getattr(
            want.value, "code", None)
    with pytest.raises(SchemaError) as got:
        CapacityPlanner({}, device="cpu")
    assert got.value.code == "bad_value"


def test_fleet_codec_round_trips():
    fleet = service.demo_fleet()
    doc = service.fleet_to_json(fleet)
    text = canonical_dumps(doc)
    assert text == jsvc.canonical_dumps(jsvc.fleet_to_json(jsvc.demo_fleet()))
    again = service.fleet_from_json(json.loads(text))
    assert again == fleet
    assert canonical_dumps(service.fleet_to_json(again)) == text
    with pytest.raises(SchemaError) as got:
        service.scenario_to_json(rt.Scenario(
            trace=(rt.SyntheticTrace(n_jobs=5), rt.SyntheticTrace(n_jobs=5)),
            total_nodes=8, multicluster=rt.Multicluster(window=16)))
    assert got.value.code == "unsupported"
    with pytest.raises(SchemaError) as got:
        service.scenario_to_json(base_scenario().with_(
            malleable=rt.MalleableModel()))
    assert got.value.code == "unsupported"


LOWERED = [
    ("batch", ScenarioDelta()),
    ("batch", ScenarioDelta(add_nodes=64, policy="backfill")),
    ("batch", ScenarioDelta(inject=(JobRequest(0, 300, 48, 400, 2),))),
    ("mesh", ScenarioDelta(alloc="spread", policy="fcfs")),
    ("mesh", ScenarioDelta(inject=(JobRequest(10, 30, 4),
                                   JobRequest(20, 40, 5)))),
    ("flaky", ScenarioDelta(mtbf=2e6, checkpoint_interval=600,
                            restart_overhead=30)),
]


@pytest.mark.parametrize("index", range(len(LOWERED)))
def test_lowered_scenarios_serialize_like_jax(index):
    """``scenario_to_json`` of the port's and the JAX package's lowered
    scenarios is the same document, and each decodes back to its own
    package's scenario."""
    name, delta = LOWERED[index]
    got = apply_delta(service.demo_fleet()[name], delta)
    want = jsvc.apply_delta(jsvc.demo_fleet()[name], as_jax_delta(delta))
    doc = service.scenario_to_json(got)
    assert canonical_dumps(doc) == jsvc.canonical_dumps(
        jsvc.scenario_to_json(want))
    assert service.scenario_from_json(json.loads(canonical_dumps(doc))) == got
    assert jax_spec(got) == want


SCENARIO_ERRORS = {
    "no_version": {"trace": {"type": "synthetic"}},
    "bad_version": {"version": 2, "trace": {"type": "synthetic"}},
    "trace_no_type": {"version": 1, "trace": {}},
    "trace_bad_type": {"version": 1, "trace": {"type": "magic"}},
    "trace_unknown_field": {"version": 1,
                            "trace": {"type": "swf", "path": "x", "y": 1}},
    "inject_jobs_not_list": {"version": 1, "trace": {
        "type": "inject", "base": {"type": "synthetic"}, "jobs": {}}},
    "topology_shape": {"version": 1, "trace": {"type": "synthetic"},
                       "total_nodes": 8,
                       "topology": {"kind": "mesh2d", "shape": [8]}},
    "failures_missing_mtbf": {"version": 1, "trace": {"type": "synthetic"},
                              "total_nodes": 8, "failures": {"seed": 1}},
    "failures_bad": {"version": 1, "trace": {"type": "synthetic"},
                     "total_nodes": 8,
                     "failures": {"mtbf": 1.0, "requeue": "never"}},
    "contention_pair": {"version": 1, "trace": {"type": "synthetic"},
                        "total_nodes": 8, "contention": [1]},
    "no_nodes": {"version": 1, "trace": {"type": "synthetic"}},
    "alloc_without_topology": {"version": 1, "trace": {"type": "synthetic"},
                               "total_nodes": 8, "alloc": "spread"},
}


@pytest.mark.parametrize("case", sorted(SCENARIO_ERRORS))
def test_scenario_codec_errors_match_jax(case):
    doc = SCENARIO_ERRORS[case]
    with pytest.raises(jsvc.SchemaError) as want:
        jsvc.scenario_from_json(doc)
    with pytest.raises(SchemaError) as got:
        service.scenario_from_json(doc)
    assert got.value.code == want.value.code
    assert str(got.value) == str(want.value).replace(
        "repro.reliability", "repro_torch.reliability")


def test_fleet_codec_errors_match_jax():
    for doc in ({"version": 1}, {"version": 2, "queues": {"a": {}}},
                {"version": 1, "queues": {}}, {"version": 1, "queues": []}):
        with pytest.raises(jsvc.SchemaError) as want:
            jsvc.fleet_from_json(doc)
        with pytest.raises(SchemaError) as got:
            service.fleet_from_json(doc)
        assert (got.value.code, str(got.value)) == (want.value.code,
                                                    str(want.value))


# ---------------------------------------------------------------------------
# HTTP (subprocess end to end)
# ---------------------------------------------------------------------------


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=SUBPROC_TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload, raw=None):
    data = raw if raw is not None else canonical_dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=SUBPROC_TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _start(args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())
    line = proc.stdout.readline()
    return proc, line


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


@pytest.mark.timeout(2 * SUBPROC_TIMEOUT + 60)
def test_http_smoke():
    """``python -m repro_torch.service --demo --device cpu``: all three
    query families over HTTP equal to in-process answers, the GET routes,
    and the reference's statuses and error bodies for bad requests."""
    proc, line = _start(["--demo", "--device", "cpu"])
    try:
        assert line.startswith("serving on http://127.0.0.1:"), (
            line + (proc.communicate(timeout=10)[0] or ""))
        url = line.split("serving on ", 1)[1].strip()

        status, health = _get(f"{url}/health")
        assert status == 200
        assert health == {"status": "ok", "version": 1,
                          "queues": ["batch", "flaky", "mesh"]}

        queries = [
            WhatIfQuery(kind="placement",
                        job=JobRequest(submit=0, runtime=400, nodes=16)),
            WhatIfQuery(kind="capacity", queue="batch",
                        deltas=(ScenarioDelta(),
                                ScenarioDelta(add_nodes=64))),
            WhatIfQuery(kind="reliability", queue="flaky",
                        mtbf_grid=(500_000.0, 2_000_000.0),
                        objective=Objective(metric="goodput", goal="max")),
        ]
        planner = CapacityPlanner(service.demo_fleet(), device="cpu")
        for q in queries:
            status, body = _post(f"{url}/query", q.to_json_dict())
            assert status == 200, body
            direct = json.loads(canonical_dumps(planner.answer(q)))
            body.pop("cache")
            direct.pop("cache")
            assert body == direct, q.kind

        status, fleet = _get(f"{url}/fleet")
        assert status == 200
        assert set(fleet["queues"]) == {"batch", "flaky", "mesh"}
        for name, qst in fleet["queues"].items():
            assert qst["summary"] == json.loads(canonical_dumps(
                service.planner.jsonable(planner.baseline_summary(name))))
        assert fleet["queues"]["mesh"]["topology"] == "mesh2d"
        status, cache = _get(f"{url}/cache")
        assert status == 200 and set(cache) == {"compiles", "hits",
                                                "entries"}

        # malformed / invalid / unknown: the reference's statuses, types
        # and messages
        def want_error(doc):
            with pytest.raises(jsvc.SchemaError) as e:
                jsvc.WhatIfQuery.from_json(doc)
            return {"error": {"type": e.value.code,
                              "message": str(e.value)}}

        bad = {"version": 1, "kind": "??"}
        assert _post(f"{url}/query", bad) == (
            400, want_error(canonical_dumps(bad)))
        assert _post(f"{url}/query", None, raw=b"{not json") == (
            400, want_error("{not json"))
        status, body = _post(
            f"{url}/query",
            WhatIfQuery(kind="capacity", queue="nope",
                        deltas=(ScenarioDelta(),)).to_json_dict())
        assert status == 404 and body["error"] == {
            "type": "unknown_queue",
            "message": str(jsvc.UnknownQueueError(
                "nope", ["batch", "mesh", "flaky"]))}
        status, body = _post(
            f"{url}/query",
            WhatIfQuery(kind="reliability", queue="batch",
                        mtbf_grid=(1e6,)).to_json_dict())
        assert status == 422 and body["error"]["type"] == "unsupported"
        assert _get(f"{url}/nope") == (404, {"error": {
            "type": "not_found", "message": "no route '/nope'; routes: "
            "/health /fleet /cache, POST /query"}})
        assert _post(f"{url}/other", {}) == (404, {"error": {
            "type": "not_found",
            "message": "no POST route '/other'; POST /query"}})
    finally:
        _stop(proc)


@pytest.mark.timeout(SUBPROC_TIMEOUT)
def test_concurrent_queries_are_serialized():
    """Handler threads share one planner and the process-wide counters:
    eight clients at once against an in-process server, with a short
    switch interval, each get the answer a lone client gets, and the
    answers' compile and hit deltas add up to the process's counts (a
    lost or misattributed update would break the sum)."""
    fleet = {"q": base_scenario("backfill", n_jobs=30)}
    queries = [WhatIfQuery(kind="placement", job=JobRequest(
        submit=10 * i, runtime=50 + i, nodes=1 + i % 4)) for i in range(8)]
    want = [without_cache(CapacityPlanner(fleet, device="cpu").answer(q))
            for q in queries]
    server = service.make_server(fleet, device="cpu")
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    results = [None] * len(queries)

    def client(i):
        results[i] = _post(f"{server.url}/query", queries[i].to_json_dict())

    interval = sys.getswitchinterval()
    rt.reset_cache_stats(clear=True)
    try:
        sys.setswitchinterval(1e-5)
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(queries))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=SUBPROC_TIMEOUT)
            assert not c.is_alive()
    finally:
        sys.setswitchinterval(interval)
        server.shutdown()
        server.server_close()
        serving.join(timeout=30)
    assert not serving.is_alive()
    assert all(status == 200 for status, _ in results)
    assert [without_cache(body) for _, body in results] == want
    stats = rt.cache_stats()
    assert (stats.compiles, stats.hits) == (1, len(queries) - 1)
    assert sum(b["cache"]["compiles"] for _, b in results) == 1
    assert sum(b["cache"]["hits"] for _, b in results) == len(queries) - 1


@pytest.mark.timeout(SUBPROC_TIMEOUT + 30)
def test_service_defaults_to_the_card():
    """Without ``--device`` the service runs on ``cuda``: with no card it
    exits with an error before serving (no fallback to the CPU)."""
    proc, line = _start(["--demo"])
    try:
        if torch.cuda.is_available():
            assert line.startswith("serving on "), line
        else:
            rest = proc.communicate(timeout=SUBPROC_TIMEOUT)[0]
            assert proc.returncode != 0
            assert not line.startswith("serving on ")
            assert "no CUDA device" in line + rest
    finally:
        if proc.poll() is None:
            _stop(proc)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CapacityPlanner(service.demo_fleet())
