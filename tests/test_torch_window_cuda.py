"""Conservative windows on the card: the lockstep cluster window, a
multicluster exchange and replay rounds on a machine, card against CPU.

A multicluster import neutralizes edges in the middle of the list and
lands rows through a ``J + 1`` buffer whose pad slot is cut off, and a
replay round builds its table from host arrays with a sentinel row; on a
CUDA device an index out of range fires a device-side assert where the
CPU may read or write past the end unnoticed, so these runs are made on
the card and held to the same runs on the CPU.  They need a CUDA device
and skip without one; the file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_window_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core import engine
from repro_torch.core.jobs import INF_TIME, POLICY_IDS, make_jobset
from repro_torch.core.parallel import (
    multicluster_result_np, simulate_multicluster, stack_jobsets,
)
from repro_torch.kernels.queue_select import ops
from repro_torch.replay import replay_trace
from repro_torch.traces import das2_like


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _clusters(device, dag: bool):
    traces = [das2_like(150, seed=60 + c) for c in range(4)]
    if dag:
        traces[0] = rt.WorkflowTrace(kind="galactic", params=(
            ("tiles", 2), ("width", 6))).materialize()
    return stack_jobsets([make_jobset(
        t["submit"], t["runtime"], t["nodes"], t.get("estimate"),
        deps=t.get("deps"), capacity=200, total_nodes=32, device=device)
        for t in traces]), traces


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ("fcfs", "backfill"))
def test_lockstep_window_card_vs_cpu(policy):
    _need_card()
    runs = []
    for dev in ("cpu", "cuda"):
        jobs, traces = _clusters(dev, dag=True)
        run = engine._BatchRun(jobs, [POLICY_IDS[policy]] * 4, [32] * 4,
                               2 * 200 + 8)
        sats = []
        horizon = max(int(np.max(t["submit"])) for t in traces)
        for t_hi in [(r + 1) * 3000 for r in range(horizon // 3000 + 2)] + [
                INF_TIME]:
            sats.append(engine.simulate_window_batch(run, t_hi, 2 * 200 + 8))
        runs.append((run, sats))
    (a, sa), (b, sb) = runs
    assert sa == sb
    for f in ("jstate", "start", "finish", "rsv_finish", "remaining",
              "n_unmet"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f).cpu()), f
    assert a.state.n_events == b.state.n_events


@pytest.mark.cuda
def test_multicluster_exchange_card_vs_cpu():
    """Migration with a DAG cluster (pinned edges, neutralized landing
    edges): equal on the card and on the CPU, and the card run launches
    the batched kernel."""
    _need_card()
    outs = []
    for dev in ("cpu", "cuda"):
        jobs, traces = _clusters(dev, dag=True)
        ops.reset_launches()
        res = simulate_multicluster(
            jobs, "backfill", [32] * 4, window=2000, max_export=6,
            horizon=int(max(np.max(t["submit"]) for t in traces)) + 40_000,
            load_imbalance_threshold=1.1, device=dev)
        outs.append(multicluster_result_np(res))
        if dev == "cuda":
            assert ops.queue_select.batch_launches > 0
    a, b = outs
    assert a["migrated"] > 0
    assert [k for k in a if not np.array_equal(np.asarray(a[k]),
                                               np.asarray(b[k]))] == []


@pytest.mark.cuda
@pytest.mark.parametrize("alloc", ("contiguous", "topo"))
def test_replay_rounds_on_a_machine_card_vs_cpu(alloc):
    _need_card()
    t = das2_like(300, seed=2)
    ft = rt.FailureModel(mtbf=30_000.0, mean_repair=2_000, horizon=1 << 19,
                         seed=7, max_failures=64).materialize(32)
    outs = []
    for dev in ("cpu", "cuda"):
        outs.append(replay_trace(
            dict(t), "backfill", total_nodes=32, window=32,
            machine=rt.Topology.mesh2d(4, 8).build(dev), alloc=alloc,
            failures=ft, device=dev))
    a, b = outs
    assert a.n_rounds > 1
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
