"""The JAX engine's golden values for the port's machine-mode runs on the card.

``chip_smoke.py`` runs the port on the card, where JAX is not installed,
and holds each 1,250-job allocation run to
``tests/data/torch_alloc_golden.json``: ``n_events``, ``makespan`` and
sha256 digests of the int32 bytes of the valid rows of ``start``,
``finish``, ``alloc_first``, ``alloc_span`` and ``alloc_sum`` and of the
``ev_lfb`` log.  The runs: Fig. alloc's grid (``benchmarks/fig_alloc.py``:
SDSC-SP2-like seed 1 on ``dragonfly(16, 8)``, backfill, the four
strategies, contention off and (1, 5)), the per-start loop on DAS-2's 400
nodes as ``mesh2d(20, 20)`` under three strategies, and preempt under
``contiguous`` on the SDSC-SP2 machine, which reaches its fallback to
``simple``.  These tests recompute every entry with ``repro.api.run`` and
fail when the file is stale.

Regenerate the file with ``PYTHONPATH=src python tests/test_torch_alloc_golden.py``.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from repro import api

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_alloc_golden.json")
N_JOBS = 1250   # 1.25x fig_alloc.py's 1,000 jobs; an eighth of phase 4's trace
SDSC = ("sdsc_sp2", 1, ("dragonfly", (16, 8)))
DAS2 = ("das2", 0, ("mesh2d", (20, 20)))
# (trace, policy, alloc, contention)
RUNS = ([(SDSC, "backfill", a, c)
         for c in (None, (1, 5))
         for a in ("simple", "contiguous", "spread", "topo")]
        + [(DAS2, "fcfs", "topo", None), (DAS2, "sjf", "spread", None),
           (DAS2, "bestfit", "contiguous", None),
           (SDSC, "preempt", "contiguous", (1, 5))])
DIGESTS = ("start", "finish", "alloc_first", "alloc_span", "alloc_sum")


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<i4").tobytes()
                          ).hexdigest()


def entry_key(e) -> tuple:
    """A golden entry's identity: (kind, topology kind, policy, alloc,
    contention as a list or None)."""
    return (e["kind"], e["topology"][0], e["policy"], e["alloc"],
            e["contention"])


def golden_entry(trace, policy, alloc, contention) -> dict:
    kind, seed, (topo_kind, shape) = trace
    out = api.run(api.Scenario(
        trace=api.SyntheticTrace(n_jobs=N_JOBS, seed=seed, kind=kind),
        topology=api.Topology(topo_kind, shape), policy=policy, alloc=alloc,
        contention=contention)).to_np()
    v = out["valid"]
    e = {"kind": kind, "seed": seed, "n_jobs": N_JOBS,
         "topology": [topo_kind, list(shape)], "policy": policy,
         "alloc": alloc,
         "contention": None if contention is None else list(contention),
         "n_events": int(out["n_events"]), "makespan": int(out["makespan"])}
    for k in DIGESTS:
        e[f"{k}_sha256"] = _digest(out[k][v])
    e["ev_lfb_sha256"] = _digest(out["ev_lfb"])
    return e


def _load():
    with open(GOLDEN) as fh:
        return json.load(fh)["runs"]


def _key(run) -> tuple:
    (kind, _, (topo_kind, _)), policy, alloc, con = run
    return (kind, topo_kind, policy, alloc,
            None if con is None else list(con))


def test_golden_file_lists_every_run():
    assert [entry_key(e) for e in _load()] == [_key(r) for r in RUNS]
    assert all(e["n_jobs"] == N_JOBS for e in _load())


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
