"""The JAX engine's golden values for the PyTorch port's on-card check.

``chip_smoke.py`` runs the port on the card, where JAX is not installed,
and holds each 5,000-job run (10,000 until the card's script needed the
time for later phases) to ``tests/data/torch_port_golden.json``:
``n_events``, ``makespan`` and sha256 digests of the int32 bytes of the
valid rows of ``start`` and ``finish``.  These tests recompute every entry
with the JAX engine (``repro.api.run``) and fail when the file is stale.

Regenerate the file with ``PYTHONPATH=src python tests/test_torch_golden.py``.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from repro import api

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_golden.json")

# (kind, seed, total_nodes, policy): the paper's two machines at 5k jobs
RUNS = ([("sdsc_sp2", 1, 128, p) for p in
         ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")]
        + [("das2", 0, 400, p) for p in ("fcfs", "backfill")])
N_JOBS = 5_000


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<i4").tobytes()
                          ).hexdigest()


def golden_entry(kind, seed, total_nodes, policy) -> dict:
    out = api.run(api.Scenario(
        trace=api.SyntheticTrace(n_jobs=N_JOBS, seed=seed, kind=kind),
        total_nodes=total_nodes, policy=policy)).to_np()
    v = out["valid"]
    return {"kind": kind, "seed": seed, "n_jobs": N_JOBS,
            "total_nodes": total_nodes, "policy": policy,
            "n_events": int(out["n_events"]), "makespan": int(out["makespan"]),
            "start_sha256": _digest(out["start"][v]),
            "finish_sha256": _digest(out["finish"][v])}


def _load():
    with open(GOLDEN) as fh:
        return json.load(fh)["runs"]


def test_golden_file_lists_every_run():
    got = [(e["kind"], e["seed"], e["total_nodes"], e["policy"])
           for e in _load()]
    assert got == RUNS
    assert all(e["n_jobs"] == N_JOBS for e in _load())


@pytest.mark.parametrize("kind,seed,total_nodes,policy", RUNS)
def test_golden_entry_is_current(kind, seed, total_nodes, policy):
    entry = next(e for e in _load()
                 if (e["kind"], e["policy"]) == (kind, policy))
    assert entry == golden_entry(kind, seed, total_nodes, policy)


if __name__ == "__main__":
    with open(GOLDEN, "w") as fh:
        json.dump({"runs": [golden_entry(*r) for r in RUNS]}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {GOLDEN}")
