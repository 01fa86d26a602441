"""The JAX engine's golden values for the port's malleable runs on the card.

``chip_smoke.py`` runs the port on the card, where JAX is not installed,
and holds each run of its ``malleable`` and ``malleable_sweep`` phases to
``tests/data/torch_mal_golden.json``: ``n_events``, ``makespan`` and
sha256 digests of the int32 bytes of the valid rows of ``start``,
``finish``, ``ready`` and every ``mal_*`` column (with failures also
``n_restarts``, ``lost_work`` and ``aborted``; on a machine the allocation
fingerprints and the ``ev_lfb`` log).  Each entry names its scenario as a
nested spec (``build`` makes it with either package's classes).

The runs: (a) ``benchmarks/des_throughput.py``'s moldable model (Amdahl
0.1, widths 1-16) on 5,000 SDSC-SP2-like jobs (seed 1, phase 4's trace
generator at half its 10,000 jobs, to keep the card run inside its time
limit) on 128 nodes, under backfill; (b) the same model on des_throughput's own
trace, ``sdsc_sp2_like(2000, seed=13)``, under backfill and fcfs; (c)
``benchmarks/fig_malleable.py``'s elastic model (Amdahl 0.05, widths
1-16, interval 64, shrink 24, grow 4, step 4) on that trace on
``mesh2d(8, 16)`` under backfill/contiguous and sjf/spread, with 4,096
ticks (the most the card phase takes: they cover the first 262,144 s of
the schedule); (d) (c)'s model in scalar mode on 128 nodes under backfill
with ``tests/test_torch_rel_golden.py``'s requeue model (MTBF 50,000 s),
which exercises failure shrinks.  The sweeps are fig_malleable.py's full
run: the 400-job ``SyntheticTrace(seed=5, congest=4)`` on 64 nodes, the
rigid baselines (fcfs, backfill) and the moldable and elastic grids
(Amdahl {0.05, 0.2, 0.5} x {fcfs, backfill}, 256 ticks), one sweep each.

These tests recompute every entry with ``repro.api.run`` (and fail when
the file is stale), and hold reduced versions of the runs (the traces cut
to 300 jobs, the sweeps' to 120) to the JAX engine through the port on the
CPU.

Regenerate the file with ``PYTHONPATH=src python tests/test_torch_mal_golden.py``.
"""

import functools
import json
import os

import pytest
from _torch_streams import diff, jax_spec
from test_torch_rel_golden import (
    FIG, build, digest, points, streams_untruncated,
)

import repro_torch as rt
from repro import api

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_mal_golden.json")

MOLD = {"type": "MalleableModel", "curve": "amdahl", "param": 0.1,
        "min_width": 1, "max_width": 16, "mode": "moldable"}
ELASTIC = {"type": "MalleableModel", "curve": "amdahl", "param": 0.05,
           "min_width": 1, "max_width": 16, "mode": "elastic",
           "interval": 64, "max_ticks": 4096, "shrink_threshold": 24,
           "grow_threshold": 4, "step": 4}
ARCHIVE = {"type": "SyntheticTrace", "n_jobs": 5000, "seed": 1,
           "kind": "sdsc_sp2"}
DES = {"type": "SyntheticTrace", "n_jobs": 2000, "seed": 13,
       "kind": "sdsc_sp2"}
MESH = {"type": "Topology", "kind": "mesh2d", "shape": [8, 16]}
DES_BASE = {"type": "Scenario", "trace": DES, "total_nodes": 128,
            "policy": "backfill", "malleable": MOLD}
RUNS = {
    "a_archive_backfill": {**DES_BASE, "trace": ARCHIVE},
    "b_des_backfill": DES_BASE,
    "b_des_fcfs": {**DES_BASE, "policy": "fcfs"},
    "c_mesh_backfill_contiguous": {**DES_BASE, "total_nodes": None,
                                   "topology": MESH, "alloc": "contiguous",
                                   "malleable": ELASTIC},
    "c_mesh_sjf_spread": {**DES_BASE, "total_nodes": None, "topology": MESH,
                          "policy": "sjf", "alloc": "spread",
                          "malleable": ELASTIC},
    "d_elastic_failures": {**DES_BASE, "malleable": ELASTIC,
                           "failures": FIG},
}
FIG_MOLD = {"type": "MalleableModel", "curve": "amdahl", "param": 0.05,
            "min_width": 1, "max_width": 16, "mode": "moldable"}
FIG_ELASTIC = {**FIG_MOLD, "mode": "elastic", "interval": 64,
               "max_ticks": 256, "shrink_threshold": 24, "grow_threshold": 4,
               "step": 4}
FIG_BASE = {"type": "Scenario", "trace": {
    "type": "SyntheticTrace", "n_jobs": 400, "seed": 5, "congest": 4},
    "total_nodes": 64, "policy": "backfill"}
FIG_AXES = {"malleable.param": [0.05, 0.2, 0.5],
            "policy": ["fcfs", "backfill"]}
# name: (base, axes); members in grid order, as sweep() expands them
SWEEPS = {
    "rigid": (FIG_BASE, {"policy": ["fcfs", "backfill"]}),
    "moldable": ({**FIG_BASE, "malleable": FIG_MOLD}, FIG_AXES),
    "elastic": ({**FIG_BASE, "malleable": FIG_ELASTIC}, FIG_AXES),
}
DIGESTS = ("start", "finish", "ready")
MAL_DIGESTS = ("mal_width", "mal_nref", "mal_nresize", "mal_node_s",
               "mal_dur")
REL_DIGESTS = ("n_restarts", "lost_work", "aborted")
ALLOC_DIGESTS = ("alloc_first", "alloc_span", "alloc_sum")


def golden_entry(name: str, spec: dict, point=None) -> dict:
    """One run of the JAX engine as a golden entry (``point``: the sweep
    point it is the solo run of)."""
    return {"name": name, "scenario": spec, "point": point,
            **_entry(json.dumps([spec, point], sort_keys=True))}


@functools.lru_cache(maxsize=None)
def _entry(key: str) -> dict:
    spec, point = json.loads(key)
    scn = build(api, spec)
    if point:
        scn = scn.with_(**{k: build(api, v) for k, v in point.items()})
    out = api.run(scn).to_np()
    v = out["valid"]
    e = {**streams_untruncated(scn), "n_jobs": int(v.sum()),
         "n_events": int(out["n_events"]), "makespan": int(out["makespan"])}
    keys = DIGESTS + MAL_DIGESTS * ("mal_width" in out) \
        + REL_DIGESTS * ("n_restarts" in out) \
        + ALLOC_DIGESTS * (scn.topology is not None)
    for k in keys:
        e[f"{k}_sha256"] = digest(out[k][v])
    if scn.topology is not None:
        e["ev_lfb_sha256"] = digest(out["ev_lfb"])
    if "mal_nresize" in out:
        e["n_resizes"] = int(out["mal_nresize"][v].sum())
    return e


def all_entries() -> dict:
    return {"runs": [golden_entry(n, s) for n, s in RUNS.items()],
            "sweeps": [{"name": n, "base": base, "axes": axes,
                        "members": [golden_entry(f"{n}/{i}", base, p)
                                    for i, p in enumerate(points(axes))]}
                       for n, (base, axes) in SWEEPS.items()]}


def load() -> dict:
    with open(GOLDEN) as fh:
        return json.load(fh)


def test_golden_file_lists_every_run():
    g = load()
    assert [e["name"] for e in g["runs"]] == list(RUNS)
    assert [(s["name"], s["base"], s["axes"]) for s in g["sweeps"]] == [
        (n, b, a) for n, (b, a) in SWEEPS.items()]
    for s in g["sweeps"]:
        assert [m["point"] for m in s["members"]] == points(s["axes"])
    runs = {e["name"]: e for e in g["runs"]}
    # the elastic runs resize, and (d)'s failures (about 1,300, none cut)
    # hit jobs with width to give
    assert all(runs[n]["n_resizes"] > 0 for n in RUNS if n[0] in "cd")
    assert 1000 < runs["d_elastic_failures"]["n_failures"] < 2048


@pytest.mark.parametrize("name", list(RUNS))
def test_golden_run_is_current(name):
    entry = next(e for e in load()["runs"] if e["name"] == name)
    assert entry == golden_entry(name, RUNS[name])


@pytest.mark.parametrize("name", list(SWEEPS))
def test_golden_sweep_is_current(name):
    """Each member's entry is its solo JAX run."""
    base, axes = SWEEPS[name]
    s = next(s for s in load()["sweeps"] if s["name"] == name)
    for i, (m, p) in enumerate(zip(s["members"], points(axes))):
        assert m == golden_entry(f"{name}/{i}", base, p), (name, p)


def _reduced(spec: dict, n_jobs: int) -> dict:
    return {**spec, "trace": {**spec["trace"], "n_jobs": n_jobs}}


@pytest.mark.parametrize("name", list(RUNS))
def test_reduced_run_matches_jax_on_the_cpu(name):
    """The run's scenario with its trace cut to 300 jobs: the port on the
    CPU equals ``repro.api.run`` in every column."""
    scn = build(rt, _reduced(RUNS[name], 300))
    got = rt.run(scn, device="cpu").to_np()
    want = api.run(jax_spec(scn)).to_np()
    assert diff(got, want) == [] and set(got) == set(want)


@pytest.mark.parametrize("name", list(SWEEPS))
def test_reduced_sweep_matches_jax_on_the_cpu(name):
    """The sweep with its trace cut to 120 jobs through the port's
    ``sweep``: one bucket, each member equal to the JAX sweep's."""
    base, axes = SWEEPS[name]
    base = _reduced(base, 120)
    axes = {k: tuple(v) for k, v in axes.items()}
    grid = rt.sweep(build(rt, base), axes=axes, device="cpu")
    assert grid.n_compiles == 1
    jgrid = api.sweep(build(api, base), axes=axes)
    for (p, r), (_, j) in zip(grid, jgrid):
        assert diff(r.to_np(), j.to_np()) == [], p


if __name__ == "__main__":
    with open(GOLDEN, "w") as fh:
        json.dump(all_entries(), fh, indent=1)
        fh.write("\n")
    print(f"wrote {GOLDEN}")
