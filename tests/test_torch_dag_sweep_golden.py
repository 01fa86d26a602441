"""The JAX engine's golden values for the members of the port's DAG sweep
on the card.

``chip_smoke.py`` phase 6g runs ``benchmarks/fig_workflow_cluster.py``'s
grid at full scale through ``sweep``: the Galactic Plane DAG of
``tests/data/torch_dag_golden.json`` (10,497 tasks) on ``dragonfly(16,
8)`` with contention (1, 5), policies fcfs, sjf, backfill and bestfit by
allocation strategies simple, contiguous and topo, one bucket of 12
members.  Each member is held to its solo run's digests in
``tests/data/torch_dag_sweep_golden.json`` (the entries' keys as in the
DAG golden file).  These tests recompute every entry with ``repro.api.run``
and fail when the file is stale.

Regenerate the file with
``PYTHONPATH=src python tests/test_torch_dag_sweep_golden.py``.
"""

import json
import os

import pytest

from test_torch_dag_golden import DAG, DRAGONFLY, entry_key, golden_entry

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_dag_sweep_golden.json")
POLICIES = ("fcfs", "sjf", "backfill", "bestfit")
ALLOCS = ("simple", "contiguous", "topo")
# grid order: policy major, as sweep(axes={"policy": ..., "alloc": ...})
RUNS = [(p, DRAGONFLY, a, [1, 5]) for p in POLICIES for a in ALLOCS]


def _key(run) -> tuple:
    policy, topology, alloc, contention = run
    return (policy, topology[0], alloc, contention)


def _load():
    with open(GOLDEN) as fh:
        return json.load(fh)["runs"]


def test_golden_file_lists_every_member():
    entries = _load()
    assert [entry_key(e) for e in entries] == [_key(r) for r in RUNS]
    assert all(e["dag"] == DAG for e in entries)


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
