"""The JAX engine's golden values for the port's multicluster runs on the
card.

``chip_smoke.py`` runs the port on the card, where JAX is not installed,
and holds each multicluster run to ``tests/data/
torch_multicluster_golden.json``: sha256 digests of the flattened
``[C, J]`` columns ``start`` and ``finish`` (int32 bytes) and ``valid``
and ``done`` (one byte a row), ``migrated``, ``dropped``, ``saturated``
and ``makespan``.  The runs: DAS-2's five clusters (144, 64, 64, 64 and
64 processors), each ``SyntheticTrace(kind="das2", n_jobs=2000,
seed=50 + c)``, backfill, ``Multicluster(window=3600)``; and the mixed
grid, whose first cluster runs the Galactic Plane DAG ``WorkflowTrace(
kind="galactic", params=(("tiles", 16), ("width", 12)))`` (657 tasks)
in place of seed 50; and ``das2x4``, the mesh's run (``chip_smoke.py``
phase ``mesh`` shards its clusters over two ranks): four clusters of 128,
64, 64 and 32 processors, each ``SyntheticTrace(kind="das2",
n_jobs=1000, seed=50 + c)``, backfill, ``Multicluster(window=3600)``,
1,280 rows a cluster (the default 1,064 leaves too few free rows: 72
imports are dropped).
These tests recompute every entry with ``repro.api.run`` (the JAX
package's ``simulate_multicluster(mesh=None)``, which
``tests/test_multicluster_sharded.py`` holds its mesh run to) and fail
when the file is stale.

Regenerate the file with
``PYTHONPATH=src python tests/test_torch_multicluster_golden.py``.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from repro import api

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_multicluster_golden.json")
NODES = (144, 64, 64, 64, 64)
WINDOW = 3600
N_JOBS = 2000
GALACTIC = {"kind": "galactic", "tiles": 16, "width": 12}
RUNS = ("das2", "mixed", "das2x4")
# each run's clusters' processors, jobs a das2 cluster and row capacity
# (None: the default)
SHAPES = {"das2": (NODES, N_JOBS, None), "mixed": (NODES, N_JOBS, None),
          "das2x4": ((128, 64, 64, 32), 1000, 1280)}


def digest(a) -> str:
    a = np.asarray(a)
    a = a.astype(np.uint8) if a.dtype == bool else a.astype("<i4")
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def traces(mod, kind: str) -> tuple:
    """The clusters' trace specs of a run, in ``mod``'s classes."""
    nodes, n_jobs, _ = SHAPES[kind]
    das2 = [mod.SyntheticTrace(kind="das2", n_jobs=n_jobs, seed=50 + c)
            for c in range(len(nodes))]
    if kind == "mixed":
        das2[0] = mod.WorkflowTrace(kind="galactic", params=(
            ("tiles", GALACTIC["tiles"]), ("width", GALACTIC["width"])))
    return tuple(das2)


def scenario(mod, kind: str, migrate: bool = True):
    return mod.Scenario(trace=traces(mod, kind),
                        total_nodes=SHAPES[kind][0],
                        capacity=SHAPES[kind][2],
                        policy="backfill",
                        multicluster=mod.Multicluster(window=WINDOW,
                                                      migrate=migrate))


def golden_entry(kind: str) -> dict:
    out = api.run(scenario(api, kind)).to_np()
    nodes, _, capacity = SHAPES[kind]
    e = {"run": kind, "nodes": list(nodes),
         **({} if capacity is None else {"capacity": capacity}),
         "n_jobs": int(out["valid"].sum()),
         "policy": "backfill", "window": WINDOW,
         "migrated": out["migrated"], "dropped": out["dropped"],
         "saturated": out["saturated"], "makespan": out["makespan"]}
    for k in ("start", "finish", "valid", "done"):
        e[f"{k}_sha256"] = digest(out[k])
    return e


def _load():
    with open(GOLDEN) as fh:
        return json.load(fh)["runs"]


def test_golden_file_lists_every_run():
    entries = _load()
    assert [e["run"] for e in entries] == list(RUNS)
    assert [e["n_jobs"] for e in entries] == [5 * N_JOBS, 4 * N_JOBS + 657,
                                              4000]
    assert all(e["dropped"] == 0 and not e["saturated"] for e in entries)
    assert all(e["migrated"] > 0 for e in entries)


@pytest.mark.parametrize("kind", RUNS)
def test_golden_entry_is_current(kind):
    entry = next(e for e in _load() if e["run"] == kind)
    assert entry == golden_entry(kind)


if __name__ == "__main__":
    with open(GOLDEN, "w") as fh:
        json.dump({"runs": [golden_entry(k) for k in RUNS]}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {GOLDEN}")
