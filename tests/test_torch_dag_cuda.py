"""Workflow DAGs on the card: padded edge lists and the pool engine.

A stacked table pads ragged edge lists with the index ``capacity``; on a
CUDA device an index out of range fires a device-side assert where the CPU
may read or write past the end unnoticed, so these runs are made on the
card and held to the same runs on the CPU.  They need a CUDA device and
skip without one; the file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_dag_cuda.py
"""

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.jobs import make_jobset
from repro_torch.kernels.queue_select import ops
from repro_torch.traces.workflows import (
    galactic_like, montage_like, random_layered, sipht_like,
    workflow_to_trace,
)

POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
CAP = 96
FIELDS = ("start", "finish", "ready", "wait", "done", "alloc_first",
          "alloc_span", "alloc_sum", "ev_lfb")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _ragged_tables(device):
    """Three DAGs of different edge counts (pads of 64, 128 and 192) and
    one table without edges, of one capacity."""
    dags = [workflow_to_trace(montage_like(8, seed=0)),
            workflow_to_trace(galactic_like(tiles=2, width=8, seed=0)),
            workflow_to_trace(random_layered(60, 5, p_edge=0.1, seed=3))]
    tables = [make_jobset(d["submit"], d["runtime"], d["nodes"],
                          d["estimate"], deps=d["deps"], capacity=CAP,
                          total_nodes=16, device=device) for d in dags]
    rng = np.random.default_rng(0)
    tables.append(make_jobset(rng.integers(0, 100, 40),
                              rng.integers(1, 50, 40),
                              rng.integers(1, 9, 40), capacity=CAP,
                              total_nodes=16, device=device))
    return tables


@pytest.mark.cuda
@pytest.mark.parametrize("machine", (False, True), ids=("scalar", "dragonfly"))
def test_padded_ragged_stack_on_card_equals_cpu(machine):
    _need_card()
    cuda, cpu = _ragged_tables("cuda"), _ragged_tables("cpu")
    assert len({t.edge_capacity for t in cuda}) == 4   # ragged, one empty
    stacked = rt.stack_jobsets(cuda)
    assert (stacked.dep_dst[3] == CAP).all()          # pad edges only
    B = len(cuda) * len(POLICIES)
    stack = rt.stack_jobsets(cuda * len(POLICIES))
    pols = [p for p in POLICIES for _ in cuda]
    kw = {}
    if machine:
        kw = dict(machine=rt.Topology.dragonfly(4, 4).build("cuda"),
                  alloc_b=["simple", "contiguous", "spread", "topo"]
                  * len(POLICIES), contention=(1, 5))
    ops.reset_launches()
    got = rt.simulate_ensemble(stack, pols, [16] * B, device="cuda", **kw)
    torch.cuda.synchronize()   # a device-side assert surfaces here
    assert ops.queue_select.batch_launches > 0
    if machine:
        kw["machine"] = rt.Topology.dragonfly(4, 4).build("cpu")
    want = rt.simulate_ensemble(rt.stack_jobsets(cpu * len(POLICIES)), pols,
                                [16] * B, device="cpu", **kw)
    assert got.n_events == want.n_events
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      getattr(want, f).cpu().numpy(),
                                      err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_dag_run_on_card_equals_cpu(policy):
    _need_card()
    scn = rt.Scenario(trace=rt.WorkflowTrace(
        kind="galactic", params=(("tiles", 3), ("width", 8)),
        priority="cpath" if policy == "preempt" else None),
        total_nodes=16, policy=policy)
    a, b = rt.run(scn, device="cuda").to_np(), rt.run(scn, device="cpu").to_np()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ("fcfs", "fcfs_fit", "cpath"))
def test_pool_engine_on_card_equals_cpu(policy):
    _need_card()
    for wf in (galactic_like(4, 8, seed=1), sipht_like(20, seed=2)):
        prio = (rt.critical_path_length(wf["exec_time"], wf["dep_pairs"])
                if policy == "cpath" else None)
        out = {}
        for dev in ("cuda", "cpu"):
            ts = rt.make_taskset(wf["exec_time"], wf["resources"],
                                 wf["dep_pairs"], priority=prio, device=dev)
            ops.reset_launches()
            out[dev] = rt.workflow_result_np(ts, rt.simulate_workflow(
                ts, np.array([16, 8192]), rt.WF_POLICY_IDS[policy],
                device=dev))
            if dev == "cuda":
                assert ops.queue_select.launches > 0
        for k in out["cpu"]:
            np.testing.assert_array_equal(out["cuda"][k], out["cpu"][k],
                                          err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("max_events", (None, 9))
def test_pool_engine_ensemble_on_card_equals_cpu(max_events):
    """The batched pool engine over ragged members (pad rows, pad edges of
    index T), mixed policies and pools and a member whose priorities reach
    INF_TIME: the card's state equals the CPU's, with batched launches."""
    _need_card()
    wfs = [galactic_like(4, 8, seed=1), sipht_like(20, seed=2),
           random_layered(60, 6, seed=3), montage_like(8, seed=4)]
    pols = ["fcfs", "fcfs_fit", "cpath", "fcfs_fit"]
    pools = np.array([[16, 8192], [8, 8192], [4, 4096], [6, 8192]])
    prios = [None, None, rt.critical_path_length(wfs[2]["exec_time"],
                                                 wfs[2]["dep_pairs"]),
             np.where(np.arange(len(wfs[3]["exec_time"])) % 2 == 1,
                      2**30 + 2, 0)]
    out = {}
    for dev in ("cuda", "cpu"):
        stack = rt.stack_tasksets([
            rt.make_taskset(w["exec_time"], w["resources"], w["dep_pairs"],
                            priority=p, device=dev)
            for w, p in zip(wfs, prios)])
        ops.reset_launches()
        out[dev] = rt.simulate_workflow_ensemble(stack, pools, pols,
                                                 max_events=max_events,
                                                 device=dev)
        if dev == "cuda":
            assert ops.queue_select_batch.launches > 0
            assert ops.queue_select.launches == 0
    for k in ("tstate", "start", "finish", "free"):
        assert torch.equal(getattr(out["cuda"], k).cpu(),
                           getattr(out["cpu"], k)), k
    assert out["cuda"].n_events == out["cpu"].n_events
    assert out["cuda"].clock == out["cpu"].clock
