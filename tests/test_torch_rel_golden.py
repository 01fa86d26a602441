"""The JAX engine's golden values for the port's node-failure runs on the card.

``chip_smoke.py`` runs the port on the card, where JAX is not installed,
and holds each run of its ``reliability`` and ``reliability_sweep`` phases
to ``tests/data/torch_rel_golden.json``: ``n_events``, ``makespan`` and
sha256 digests of the int32 bytes of the valid rows of ``start``,
``finish``, ``ready``, ``n_restarts``, ``lost_work`` and ``aborted`` (on
a machine also of the allocation fingerprints and of the ``ev_lfb`` log).
Each entry names its scenario as a nested spec (:func:`build` makes it
with either package's classes), and every failure stream is untruncated.

The runs are ``benchmarks/fig_reliability.py``'s at half its size (the
card's script needed the time for later phases): 1,000 congested
SDSC-SP2-like jobs on 128 nodes, backfill, per-node MTBF 50,000 s over a
horizon of 2^19 s under requeue and abort; 5,000 SDSC-SP2-like jobs (seed
1) at MTBF 400,000 s over 2^22 s;
the requeue model on ``dragonfly(16, 8)`` under backfill/simple and
fcfs/contiguous; the requeue model under preempt; and the Galactic Plane
DAG (10,497 tasks) under fcfs with aborts at MTBF 5,000 s.  The sweeps
are the figure's MTBF x kill-rule grid (12 members) and its checkpoint
axis (4 members); each member's entry is its solo run.  These tests
recompute every entry with ``repro.api.run`` and fail when the file is
stale.

Regenerate the file with ``PYTHONPATH=src python tests/test_torch_rel_golden.py``.
"""

import functools
import hashlib
import itertools
import json
import os

import numpy as np
import pytest

from repro import api

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_rel_golden.json")

FIG = {"type": "FailureModel", "mtbf": 50e3, "seed": 3, "mean_repair": 600,
       "horizon": 2**19, "max_failures": 2048, "checkpoint_interval": 3600}
FIG_TRACE = {"type": "SyntheticTrace", "n_jobs": 1000, "seed": 11,
             "kind": "sdsc_sp2", "congest": 4}
FIG_BASE = {"type": "Scenario", "trace": FIG_TRACE, "total_nodes": 128,
            "policy": "backfill", "failures": FIG}
DRAGONFLY = {"type": "Topology", "kind": "dragonfly", "shape": [16, 8]}
RUNS = {
    "a_requeue": FIG_BASE,
    "a_abort": {**FIG_BASE, "failures": {**FIG, "requeue": "abort"}},
    "b_archive": {**FIG_BASE, "trace": {
        "type": "SyntheticTrace", "n_jobs": 5_000, "seed": 1,
        "kind": "sdsc_sp2"}, "failures": {
            **FIG, "mtbf": 400e3, "horizon": 2**22}},
    "c_backfill_simple": {**FIG_BASE, "total_nodes": None,
                          "topology": DRAGONFLY, "alloc": "simple"},
    "c_fcfs_contiguous": {**FIG_BASE, "total_nodes": None,
                          "topology": DRAGONFLY, "policy": "fcfs",
                          "alloc": "contiguous"},
    "d_preempt": {**FIG_BASE, "policy": "preempt"},
    "e_galactic_abort": {
        "type": "Scenario", "trace": {
            "type": "WorkflowTrace", "kind": "galactic", "seed": 0,
            "params": [["tiles", 256], ["width", 12]]},
        "total_nodes": 128, "policy": "fcfs", "failures": {
            **FIG, "mtbf": 5e3, "horizon": 4096, "max_failures": 256,
            "requeue": "abort", "checkpoint_interval": 0}},
}
# name: (base, axes); members in grid order, as sweep() expands them
SWEEPS = {
    "mtbf": (FIG_BASE, {"failures.mtbf": [50e3, 100e3, 200e3, 400e3, 800e3,
                                          1600e3],
                        "failures.requeue": ["requeue", "abort"]}),
    "ckpt": (FIG_BASE, {"failures.checkpoint_interval": [0, 600, 3600,
                                                         14400]}),
}
DIGESTS = ("start", "finish", "ready")
REL_DIGESTS = ("n_restarts", "lost_work", "aborted")
SVC_DIGESTS = ("slo_met", "deadline", "class_id")
ALLOC_DIGESTS = ("alloc_first", "alloc_span", "alloc_sum")


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<i4").tobytes()
                          ).hexdigest()


def build(mod, spec):
    """A nested spec (dicts with a ``type``, lists for tuples) made with
    the classes of ``mod`` (``repro.api`` or ``repro_torch``)."""
    if isinstance(spec, dict) and "type" in spec:
        return getattr(mod, spec["type"])(**{
            k: build(mod, v) for k, v in spec.items()
            if k != "type" and v is not None})
    if isinstance(spec, list):
        return tuple(build(mod, v) for v in spec)
    return spec


def points(axes: dict) -> list:
    """The grid points of ``axes`` in sweep order (the first axis major)."""
    return [dict(zip(axes, combo)) for combo in itertools.product(
        *axes.values())]


def streams_untruncated(scn) -> dict:
    """The sizes of a scenario's streams, asserting neither was cut."""
    out = {}
    if scn.failures is not None:
        ft = scn.failures.materialize(int(scn.total_nodes))
        assert not ft.truncated, "failure stream truncated"
        out["n_failures"] = ft.n_failures
    if hasattr(scn.trace, "plan"):
        plan = scn.trace.plan()
        assert not plan.truncated, "service trace truncated"
        out["n_requests"] = plan.n_requests
    return out


def golden_entry(name: str, spec: dict, point=None) -> dict:
    """One run of the JAX engine as a golden entry (``point``: the sweep
    point it is the solo run of)."""
    return {"name": name, "scenario": spec, "point": point,
            **_entry(json.dumps([spec, point], sort_keys=True))}


@functools.lru_cache(maxsize=None)
def _entry(key: str) -> dict:
    """A golden entry's values, once a process for each (spec, point)."""
    spec, point = json.loads(key)
    scn = build(api, spec)
    if point:
        scn = scn.with_(**{k: build(api, v) for k, v in point.items()})
    out = api.run(scn).to_np()
    v = out["valid"]
    e = {**streams_untruncated(scn), "n_jobs": int(v.sum()),
         "n_events": int(out["n_events"]), "makespan": int(out["makespan"])}
    keys = DIGESTS + REL_DIGESTS * ("n_restarts" in out) \
        + SVC_DIGESTS * ("slo_met" in out) \
        + ALLOC_DIGESTS * (scn.topology is not None)
    for k in keys:
        e[f"{k}_sha256"] = digest(out[k][v])
    for k in ("cap_online", "cap_time") * ("slo_met" in out):
        e[f"{k}_sha256"] = digest(out[k])
        e[f"n_{k}"] = int(len(out[k]))
    if scn.topology is not None:
        e["ev_lfb_sha256"] = digest(out["ev_lfb"])
    return e


def all_entries(runs: dict, sweeps: dict) -> dict:
    return {"runs": [golden_entry(n, s) for n, s in runs.items()],
            "sweeps": [{"name": n, "base": base, "axes": axes,
                        "members": [golden_entry(f"{n}/{i}", base, p)
                                    for i, p in enumerate(points(axes))]}
                       for n, (base, axes) in sweeps.items()]}


def load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def write(path: str, runs: dict, sweeps: dict) -> None:
    with open(path, "w") as fh:
        json.dump(all_entries(runs, sweeps), fh, indent=1)
        fh.write("\n")
    print(f"wrote {path}")


def test_golden_file_lists_every_run():
    g = load(GOLDEN)
    assert [e["name"] for e in g["runs"]] == list(RUNS)
    assert [(s["name"], s["base"], s["axes"]) for s in g["sweeps"]] == [
        (n, b, a) for n, (b, a) in SWEEPS.items()]
    for s in g["sweeps"]:
        assert [m["point"] for m in s["members"]] == points(s["axes"])
    # the figure's harshest point is about 1,300 failures, none cut
    assert 1000 < g["runs"][0]["n_failures"] < 2048


@pytest.mark.parametrize("name", list(RUNS))
def test_golden_run_is_current(name):
    entry = next(e for e in load(GOLDEN)["runs"] if e["name"] == name)
    assert entry == golden_entry(name, RUNS[name])


@pytest.mark.parametrize("name", list(SWEEPS))
def test_golden_sweep_is_current(name):
    """Each member's entry is its solo JAX run (a sweep member equals its
    solo run bit for bit in both engines)."""
    base, axes = SWEEPS[name]
    s = next(s for s in load(GOLDEN)["sweeps"] if s["name"] == name)
    for i, (m, p) in enumerate(zip(s["members"], points(axes))):
        assert m == golden_entry(f"{name}/{i}", base, p), (name, p)


if __name__ == "__main__":
    write(GOLDEN, RUNS, SWEEPS)
