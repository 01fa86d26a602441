"""The JAX engine's golden values for the port's serving runs on the card.

``chip_smoke.py``'s ``serving`` and ``serving_sweep`` phases hold each run
to ``tests/data/torch_serving_golden.json``: ``n_events``, ``makespan`` and
sha256 digests of the valid rows of ``start``, ``finish``, ``ready``,
``slo_met``, ``deadline`` and ``class_id``, and of the capacity log
``cap_online``/``cap_time`` (with failures also ``n_restarts``,
``lost_work`` and ``aborted``; on a machine the allocation fingerprints
and ``ev_lfb``), in the format of ``test_torch_rel_golden.py``.

The runs are ``benchmarks/fig_serving.py``'s at full size: Poisson
arrivals at 0.05 requests/s over 2^16 s (about 3,300 requests), an
interactive class (1 node, 30 s, SLO 60 s) and a batch class (8 nodes,
exponential 600 s, SLO 1,800 s, weight 0.3), on 64 nodes with the
queue-pressure autoscaler (up at 48 queued nodes, down at 8, 16-64 nodes,
steps of 8 every 256 s, 256 ticks): fcfs and sjf with the autoscaler on,
fcfs with it off; fcfs/simple and sjf/contiguous on ``mesh2d(8, 8)``; and
fcfs with the autoscaler and a failure model (MTBF 50,000 s over the
horizon) composed.  The sweep is the figure's grid, five rates x fcfs/sjf
x autoscaler on/off, 20 members; each member's entry is its solo run.
These tests recompute every entry with ``repro.api.run`` and fail when the
file is stale.

Regenerate the file with
``PYTHONPATH=src python tests/test_torch_serving_golden.py``.
"""

import os

import pytest

from test_torch_rel_golden import golden_entry, load, points, write

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_serving_golden.json")

AUTO = {"type": "AutoscalePolicy", "up_threshold": 48, "down_threshold": 8,
        "min_nodes": 16, "max_nodes": 64, "step": 8, "interval": 256,
        "max_ticks": 256}
AUTO_OFF = {**AUTO, "enabled": False}
CLASSES = [
    {"type": "ServiceClass", "name": "interactive", "nodes": 1,
     "mean_runtime": 30, "slo_wait": 60},
    {"type": "ServiceClass", "name": "batch", "nodes": 8,
     "mean_runtime": 600, "dist": "exponential", "slo_wait": 1800,
     "weight": 0.3},
]
FIG_TRACE = {"type": "ServiceTrace", "horizon": 2**16, "rate": 0.05,
             "seed": 5, "max_jobs": 4096, "classes": CLASSES,
             "autoscale": AUTO}
FIG_BASE = {"type": "Scenario", "trace": FIG_TRACE, "total_nodes": 64,
            "policy": "fcfs"}
MESH = {"type": "Topology", "kind": "mesh2d", "shape": [8, 8]}
RUNS = {
    "fcfs": FIG_BASE,
    "sjf": {**FIG_BASE, "policy": "sjf"},
    "fcfs_off": {**FIG_BASE, "trace": {**FIG_TRACE, "autoscale": AUTO_OFF}},
    "mesh_fcfs_simple": {**FIG_BASE, "total_nodes": None, "topology": MESH,
                         "alloc": "simple"},
    "mesh_sjf_contiguous": {**FIG_BASE, "total_nodes": None,
                            "topology": MESH, "policy": "sjf",
                            "alloc": "contiguous"},
    "fcfs_failures": {**FIG_BASE, "failures": {
        "type": "FailureModel", "mtbf": 50e3, "seed": 3, "mean_repair": 600,
        "horizon": 2**16, "max_failures": 256, "checkpoint_interval": 3600}},
}
SWEEPS = {
    "grid": (FIG_BASE, {"trace.rate": [0.010, 0.020, 0.030, 0.040, 0.050],
                        "policy": ["fcfs", "sjf"],
                        "trace.autoscale": [AUTO, AUTO_OFF]}),
}


def test_golden_file_lists_every_run():
    g = load(GOLDEN)
    assert [e["name"] for e in g["runs"]] == list(RUNS)
    assert [(s["name"], s["base"], s["axes"]) for s in g["sweeps"]] == [
        (n, b, a) for n, (b, a) in SWEEPS.items()]
    for s in g["sweeps"]:
        assert [m["point"] for m in s["members"]] == points(s["axes"])
    assert 3000 < g["runs"][0]["n_requests"] < 4096
    assert g["runs"][0]["n_cap_online"] > 0          # the autoscaler ticked
    assert g["runs"][2]["n_cap_online"] == 0         # ... and here it is off


@pytest.mark.parametrize("name", list(RUNS))
def test_golden_run_is_current(name):
    entry = next(e for e in load(GOLDEN)["runs"] if e["name"] == name)
    assert entry == golden_entry(name, RUNS[name])


@pytest.mark.parametrize("name", list(SWEEPS))
def test_golden_sweep_is_current(name):
    base, axes = SWEEPS[name]
    s = next(s for s in load(GOLDEN)["sweeps"] if s["name"] == name)
    for i, (m, p) in enumerate(zip(s["members"], points(axes))):
        assert m == golden_entry(f"{name}/{i}", base, p), (name, p)


if __name__ == "__main__":
    write(GOLDEN, RUNS, SWEEPS)
