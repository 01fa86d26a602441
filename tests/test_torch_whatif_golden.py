"""The JAX planner's answers for the port's what-if phase on the card.

``chip_smoke.py``'s ``whatif`` phase runs the port's capacity planner on
the card, where JAX is not installed, and holds every cold-pass answer to
``tests/data/torch_whatif_golden.json``: the canonical answer documents
themselves (without the process's ``cache.entries`` counter), so a card
run can name the first key that differs, and each family's compile and
hit counts.

The fleet is ``demo_fleet``'s three queues at 500 jobs each, two and a
half times the demo's 200 (about five days of the SDSC-SP2 log's arrival
rate; 1,000 until the card's script needed the time for later phases):
``batch``, ``sdsc_sp2`` on 128 nodes under fcfs; ``mesh``,
``Topology.mesh2d(8, 16)`` under sjf with ``contiguous``; ``flaky``,
backfill with ``FailureModel(mtbf=1e6, seed=7, max_failures=512)``.  The
queries are ``benchmarks/fig_whatif.py``'s full set: placement of 400 s
jobs of 4, 16 and 48 nodes over every queue; ``add_nodes`` 0, 32, 64 and
128 on ``batch``; MTBF 500e3, 1e6, 2e6 and 4e6 on ``flaky`` (goodput,
max).  Each family is answered by a fresh planner after
``reset_cache_stats(clear=True)``.

These tests recompute every answer with ``repro.service`` (and fail when
the file is stale), check that no reliability point saturates the fleet's
failure capacity, and answer each family through the port on the CPU
against the file.

Regenerate the file with
``PYTHONPATH=src python tests/test_torch_whatif_golden.py``.
"""

import json
import os

import pytest

import repro_torch as rt
from repro import api
from repro import service as jsvc
from repro_torch import service

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_whatif_golden.json")
N_JOBS = 500
FAMILIES = ("placement", "capacity", "reliability")
MTBF_GRID = (500e3, 1000e3, 2000e3, 4000e3)


def card_fleet(m):
    """The card's fleet in the package ``m`` (``repro_torch`` or
    ``repro.api``)."""
    return {
        "batch": m.Scenario(
            trace=m.SyntheticTrace(n_jobs=N_JOBS, seed=0, kind="sdsc_sp2"),
            total_nodes=128, policy="fcfs"),
        "mesh": m.Scenario(
            trace=m.SyntheticTrace(n_jobs=N_JOBS, seed=1, kind="sdsc_sp2"),
            topology=m.Topology.mesh2d(8, 16), policy="sjf",
            alloc="contiguous"),
        "flaky": m.Scenario(
            trace=m.SyntheticTrace(n_jobs=N_JOBS, seed=2, kind="sdsc_sp2"),
            total_nodes=128, policy="backfill",
            failures=m.FailureModel(mtbf=1_000_000.0, seed=7,
                                    max_failures=512)),
    }


def card_queries(svc):
    """fig_whatif.py's full query set in the service package ``svc``."""
    return {
        "placement": [
            svc.WhatIfQuery(kind="placement",
                            job=svc.JobRequest(submit=0, runtime=400,
                                               nodes=w))
            for w in (4, 16, 48)],
        "capacity": [
            svc.WhatIfQuery(kind="capacity", queue="batch",
                            deltas=tuple(svc.ScenarioDelta(add_nodes=d)
                                         for d in (0, 32, 64, 128)))],
        "reliability": [
            svc.WhatIfQuery(kind="reliability", queue="flaky",
                            mtbf_grid=MTBF_GRID,
                            objective=svc.Objective(metric="goodput",
                                                    goal="max"))],
    }


def without_entries(answer) -> dict:
    """The answer as its canonical document, ``cache.entries`` dropped."""
    doc = json.loads(service.canonical_dumps(answer))
    doc["cache"].pop("entries")
    return doc


def family_entry(family: str) -> dict:
    """One family's cold pass through the JAX planner."""
    queries = card_queries(jsvc)[family]
    api.reset_cache_stats(clear=True)
    planner = jsvc.CapacityPlanner(card_fleet(api))
    answers = [without_entries(planner.answer(q)) for q in queries]
    stats = api.cache_stats()
    return {"queries": [q.to_json_dict() for q in queries],
            "answers": answers, "compiles": stats.compiles,
            "hits": stats.hits}


def all_entries() -> dict:
    return {"n_jobs": N_JOBS,
            "fleet": jsvc.fleet_to_json(card_fleet(api)),
            "families": {f: family_entry(f) for f in FAMILIES}}


def _golden() -> dict:
    with open(GOLDEN) as fh:
        return json.load(fh)


def test_fleet_and_queries_are_current():
    golden = _golden()
    assert golden["n_jobs"] == N_JOBS
    assert golden["fleet"] == service.fleet_to_json(card_fleet(rt)) == \
        jsvc.fleet_to_json(card_fleet(api))
    for family, queries in card_queries(service).items():
        assert golden["families"][family]["queries"] == [
            q.to_json_dict() for q in queries]


@pytest.mark.parametrize("family", FAMILIES)
def test_golden_answers_are_current(family):
    """The JAX planner's cold pass, recomputed, equals the file's."""
    assert family_entry(family) == _golden()["families"][family]


def test_reliability_points_do_not_saturate():
    """No point of the reliability grid (nor the queue as it is) truncates
    its failure stream at the fleet's padded capacity: a truncated stream
    measures the cutoff, not reliability."""
    flaky = card_fleet(rt)["flaky"]
    for mtbf in (flaky.failures.mtbf, *MTBF_GRID):
        trace = flaky.with_(**{"failures.mtbf": mtbf}).failures.materialize(
            int(flaky.total_nodes))
        assert not trace.truncated, mtbf


@pytest.mark.parametrize("family", FAMILIES)
def test_port_answers_match_golden(family):
    """The port's planner on the CPU, a fresh planner after
    ``reset_cache_stats(clear=True)``: every answer and both counts equal
    the file's."""
    want = _golden()["families"][family]
    rt.reset_cache_stats(clear=True)
    planner = service.CapacityPlanner(card_fleet(rt), device="cpu")
    for query, doc in zip(card_queries(service)[family], want["answers"]):
        assert without_entries(planner.answer(query)) == doc
    stats = rt.cache_stats()
    assert (stats.compiles, stats.hits) == (want["compiles"], want["hits"])


if __name__ == "__main__":
    with open(GOLDEN, "w") as fh:
        json.dump(all_entries(), fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {GOLDEN}")
