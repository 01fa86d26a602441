"""Node failures and serving on the card, held to the same runs on the CPU.

A painted node carries the out-of-range owner id ``J``, and an abort
decrements its dependents through a buffer whose last slot takes the pad
edges; on a CUDA device an index out of range fires a device-side assert
where the CPU may read past the end unnoticed, so these runs are made on
the card: a machine-mode failure run (placements and caps through the
painted map, kills freeing the true map), aborts on a DAG (solo and in an
ensemble of ragged edge lists), and an autoscaled ``mesh2d`` run (offline
masks), each equal to its CPU run column for column.  They need a CUDA
device and skip without one; the file imports neither JAX nor the JAX
package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_rel_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.kernels.queue_select import ops

FM = rt.FailureModel(mtbf=300.0, seed=7, mean_repair=50, horizon=4000,
                     max_failures=48, checkpoint_interval=20,
                     restart_overhead=5)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _trace(n=80, seed=1):
    rng = np.random.default_rng(seed)
    return rt.ArrayTrace(submit=rng.integers(0, 400, n),
                         runtime=rng.integers(5, 80, n),
                         nodes=rng.integers(1, 6, n),
                         estimate=rng.integers(5, 100, n))


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _card_equals_cpu(scn) -> dict:
    ops.reset_launches()
    card = rt.run(scn, device="cuda").to_np()
    assert ops.queue_select.launches + ops.shadow_walk.launches > 0 or (
        scn.policy in ("fcfs", "sjf", "ljf") and scn.topology is None)
    _same(card, rt.run(scn, device="cpu").to_np())
    return card


@pytest.mark.cuda
@pytest.mark.parametrize("requeue", ("requeue", "abort"))
@pytest.mark.parametrize("policy,alloc", [
    ("fcfs", "contiguous"), ("backfill", "simple"), ("sjf", "topo"),
    ("bestfit", "spread")])
def test_machine_failures_on_card_equal_cpu(policy, alloc, requeue):
    _need_card()
    out = _card_equals_cpu(rt.Scenario(
        trace=_trace(), topology=rt.Topology.dragonfly(4, 4), policy=policy,
        alloc=alloc, failures=dataclasses.replace(FM, requeue=requeue)))
    assert out["n_restarts"].sum() + out["aborted"].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("scalar", "mesh"))
@pytest.mark.parametrize("policy", ("fcfs", "backfill"))
def test_aborts_on_a_dag_on_card_equal_cpu(policy, mode):
    _need_card()
    kw = (dict(total_nodes=16) if mode == "scalar" else
          dict(topology=rt.Topology.mesh2d(4, 4), alloc="contiguous"))
    out = _card_equals_cpu(rt.Scenario(
        trace=rt.WorkflowTrace(kind="montage", params=(("width", 8),)),
        policy=policy, failures=rt.FailureModel(
            mtbf=150.0, seed=4, mean_repair=30, horizon=3000,
            max_failures=64, requeue="abort"), **kw))
    assert out["aborted"].any()


@pytest.mark.cuda
def test_aborts_in_a_ragged_dag_ensemble_on_card_equal_cpu():
    """Seeds of a random layered DAG (ragged edge lists, pad edges in
    every member) under aborts, one bucket: card equals CPU member by
    member."""
    _need_card()
    scn = rt.Scenario(
        trace=rt.WorkflowTrace(kind="random", params=(
            ("n_tasks", 120), ("n_layers", 8), ("p_edge", 0.05))),
        total_nodes=16, policy="backfill", failures=rt.FailureModel(
            mtbf=200.0, seed=2, mean_repair=30, horizon=3000,
            max_failures=64, requeue="abort"))
    axes = {"trace.seed": (0, 1, 2), "failures.mtbf": (100.0, 400.0)}
    card = rt.sweep(scn, axes=axes, device="cuda")
    cpu = rt.sweep(scn, axes=axes, device="cpu")
    assert card.n_compiles == 1
    for a, b in zip(card.results, cpu.results):
        _same(a.to_np(), b.to_np())


@pytest.mark.cuda
@pytest.mark.parametrize("policy,alloc", [
    ("fcfs", "simple"), ("sjf", "contiguous"), ("backfill", "spread")])
def test_autoscaled_mesh_on_card_equals_cpu(policy, alloc):
    _need_card()
    out = _card_equals_cpu(rt.Scenario(
        trace=rt.ServiceTrace(
            horizon=1500, rate=0.08, seed=7, max_jobs=256,
            classes=(rt.ServiceClass("small", nodes=1, mean_runtime=30,
                                     slo_wait=40),
                     rt.ServiceClass("big", nodes=4, mean_runtime=120,
                                     dist="exponential", slo_wait=200,
                                     weight=0.3)),
            autoscale=rt.AutoscalePolicy(
                up_threshold=6, down_threshold=1, min_nodes=4, step=2,
                interval=50, max_ticks=64)),
        topology=rt.Topology.mesh2d(4, 4), policy=policy, alloc=alloc))
    cap = out["cap_online"]
    assert (np.diff(cap) > 0).any() and (np.diff(cap) < 0).any()
