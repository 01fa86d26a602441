"""The JAX engine's golden values for the port's workflow-DAG runs on the card.

``chip_smoke.py`` runs the port on the card, where JAX is not installed,
and holds each Galactic Plane run to ``tests/data/torch_dag_golden.json``:
``n_events``, ``makespan`` and sha256 digests of the int32 bytes of the
valid rows of ``start``, ``finish`` and ``ready`` (and, on a machine, of
``alloc_first``, ``alloc_span``, ``alloc_sum`` and the ``ev_lfb`` log).
The trace is ``galactic_like(tiles=128, width=12, seed=0)``: 5,249 tasks
and 9,472 edges (tiles=256, 10,497 tasks, until the card's script needed
the time for later phases).  The runs: the six policies in scalar mode on
SDSC-SP2's 128 nodes (preempt over critical-path priorities), and
backfill/topo, fcfs/contiguous and sjf/simple on ``dragonfly(16, 8)`` with
contention (1, 5).  These tests recompute every entry with
``repro.api.run`` and fail when the file is stale.

Regenerate the file with ``PYTHONPATH=src python tests/test_torch_dag_golden.py``.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from repro import api

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_dag_golden.json")
DAG = {"kind": "galactic", "tiles": 128, "width": 12, "seed": 0}
TOTAL_NODES = 128
DRAGONFLY = ["dragonfly", [16, 8]]
# (policy, topology, alloc, contention)
RUNS = ([(p, None, None, None) for p in
         ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")]
        + [(p, DRAGONFLY, a, [1, 5]) for p, a in
           (("backfill", "topo"), ("fcfs", "contiguous"), ("sjf", "simple"))])
DIGESTS = ("start", "finish", "ready")
ALLOC_DIGESTS = ("alloc_first", "alloc_span", "alloc_sum")


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<i4").tobytes()
                          ).hexdigest()


def dag_trace(dag: dict, priority=None):
    """The ``repro.api.WorkflowTrace`` of a golden entry's ``dag``."""
    params = tuple((k, dag[k]) for k in ("tiles", "width", "n_tasks",
                                         "n_layers", "p_edge") if k in dag)
    return api.WorkflowTrace(kind=dag["kind"], seed=dag["seed"],
                             params=params, priority=priority)


def golden_entry(dag, policy, topology, alloc, contention) -> dict:
    """One run of the JAX engine as a golden entry.  Preempt runs over
    critical-path priorities."""
    priority = "cpath" if policy == "preempt" else None
    kw = (dict(total_nodes=TOTAL_NODES) if topology is None else dict(
        topology=api.Topology(topology[0], tuple(topology[1])), alloc=alloc,
        contention=tuple(contention)))
    trace = dag_trace(dag, priority)
    out = api.run(api.Scenario(trace=trace, policy=policy, **kw)).to_np()
    v = out["valid"]
    e = {"dag": dag, "priority": priority, "n_jobs": int(v.sum()),
         "n_edges": len(trace.materialize()["deps"]),
         "topology": topology, "total_nodes": TOTAL_NODES, "policy": policy,
         "alloc": alloc, "contention": contention,
         "n_events": int(out["n_events"]), "makespan": int(out["makespan"])}
    for k in DIGESTS + (ALLOC_DIGESTS if topology is not None else ()):
        e[f"{k}_sha256"] = digest(out[k][v])
    if topology is not None:
        e["ev_lfb_sha256"] = digest(out["ev_lfb"])
    return e


def entry_key(e) -> tuple:
    return (e["policy"], None if e["topology"] is None else e["topology"][0],
            e["alloc"], e["contention"])


def _key(run) -> tuple:
    policy, topology, alloc, contention = run
    return (policy, None if topology is None else topology[0], alloc,
            contention)


def _load():
    with open(GOLDEN) as fh:
        return json.load(fh)["runs"]


def test_golden_file_lists_every_run():
    entries = _load()
    assert [entry_key(e) for e in entries] == [_key(r) for r in RUNS]
    assert all(e["dag"] == DAG and e["n_jobs"] == 5_249
               and e["n_edges"] == 9_472 for e in entries)


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "-".join(
    map(str, _key(r))))
def test_golden_entry_is_current(run):
    entry = next(e for e in _load() if entry_key(e) == _key(run))
    assert entry == golden_entry(DAG, *run)


if __name__ == "__main__":
    with open(GOLDEN, "w") as fh:
        json.dump({"runs": [golden_entry(DAG, *r) for r in RUNS]}, fh,
                  indent=1)
        fh.write("\n")
    print(f"wrote {GOLDEN}")
