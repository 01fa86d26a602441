"""The JAX pool engine's golden values for the port's workflow runs on the
card.

``chip_smoke.py`` phase 6h runs the port's ``simulate_workflow`` on the
card and holds each run to ``tests/data/torch_workflow_golden.json``:
``n_events``, ``makespan`` and sha256 digests of the int32 bytes of the
valid rows of ``start``, ``finish`` and ``ready``.  The runs are those of
the paper's Figs. 6 and 7 (``benchmarks/fig6_workflow_scaling.py``,
``fig7_workflow_wait.py``): ``galactic_like(tiles, 12, seed=tiles)`` for
tiles 2, 4, 8, 16 and 64 on pools ``[64, 1 << 20]``, and
``sipht_like(width, seed=width)`` for widths 10, 30 and 60 on pools ``[8,
8192]``, each under fcfs, fcfs_fit and cpath (critical-path priorities).
These tests recompute every entry with ``repro.core.workflow`` and fail
when the file is stale.

Regenerate the file with
``PYTHONPATH=src python tests/test_torch_workflow_golden.py``.
"""

import json
import os

import numpy as np
import pytest

from repro.core.workflow import (
    WF_POLICY_IDS, critical_path_length, make_taskset, simulate_workflow,
    workflow_result_np,
)
from repro.traces import workflows as W
from test_torch_dag_golden import digest

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_workflow_golden.json")
GALACTIC_POOLS = [64, 1 << 20]
SIPHT_POOLS = [8, 8192]
POLICIES = ("fcfs", "fcfs_fit", "cpath")
# (generator, size, pools)
DAGS = ([("galactic", t, GALACTIC_POOLS) for t in (2, 4, 8, 16, 64)]
        + [("sipht", w, SIPHT_POOLS) for w in (10, 30, 60)])
RUNS = [(g, k, pools, p) for g, k, pools in DAGS for p in POLICIES]


def workflow(kind: str, size: int) -> dict:
    """Fig. 6's ``galactic_like(size, 12, seed=size)`` or Fig. 7's
    ``sipht_like(size, seed=size)``."""
    if kind == "galactic":
        return W.galactic_like(size, 12, seed=size)
    return W.sipht_like(size, seed=size)


def golden_entry(kind, size, pools, policy) -> dict:
    wf = workflow(kind, size)
    prio = (critical_path_length(wf["exec_time"], wf["dep_pairs"])
            if policy == "cpath" else None)
    ts = make_taskset(wf["exec_time"], wf["resources"], wf["dep_pairs"],
                      priority=prio)
    out = workflow_result_np(ts, simulate_workflow(
        ts, np.asarray(pools), WF_POLICY_IDS[policy]))
    v = out["valid"]
    e = {"kind": kind, "size": size, "pools": list(pools), "policy": policy,
         "n_tasks": int(v.sum()), "n_edges": len(wf["dep_pairs"]),
         "n_events": out["n_events"], "makespan": out["makespan"],
         "done": bool(out["done"][v].all())}
    for k in ("start", "finish", "ready"):
        e[f"{k}_sha256"] = digest(out[k][v])
    return e


def _key(run) -> tuple:
    kind, size, _, policy = run
    return (kind, size, policy)


def entry_key(e) -> tuple:
    return (e["kind"], e["size"], e["policy"])


def _load():
    with open(GOLDEN) as fh:
        return json.load(fh)["runs"]


def test_golden_file_lists_every_run():
    assert [entry_key(e) for e in _load()] == [_key(r) for r in RUNS]


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "-".join(
    map(str, _key(r))))
def test_golden_entry_is_current(run):
    entry = next(e for e in _load() if entry_key(e) == _key(run))
    assert entry == golden_entry(*run)


if __name__ == "__main__":
    with open(GOLDEN, "w") as fh:
        json.dump({"runs": [golden_entry(*r) for r in RUNS]}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {GOLDEN}")
