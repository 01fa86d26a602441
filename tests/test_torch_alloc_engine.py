"""Machine-mode runs of the port (on the CPU) against the JAX engine and the
host oracle.

Every policy x strategy x contention case, on small ``linear``, ``mesh2d``
and ``dragonfly`` machines of 64 nodes (one JAX executable a policy and
strategy serves all three), must give ``repro_torch.run(...).to_np()``
equal to ``repro.api.run(...).to_np()`` on every key, ``alloc_first``,
``alloc_span``, ``alloc_sum`` and the ``ev_*`` log included, and equal to
``repro.api.run_ref`` with ``matches(node_maps=True)``; ``summary()`` (with
``alloc_summary``) and the allocation series must be equal too.  The trace
is a congested SDSC-SP2-like one of 200 jobs, whose priority tiers make
preempt suspend jobs, so that ``contiguous`` reaches its fallback.
"""

import numpy as np
import pytest

import repro_torch as rt
from repro import api
from repro.core import metrics as jax_metrics
from repro_torch.core import engine
from repro_torch.core import metrics

POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
STRATEGIES = ("simple", "contiguous", "spread", "topo")
TOPOLOGIES = {"linear": ("linear", (64, 8)), "mesh2d": ("mesh2d", (8, 8)),
              "dragonfly": ("dragonfly", (8, 8))}
CONTENTIONS = (None, (1, 5))
TRACE = dict(n_jobs=200, seed=3, kind="sdsc_sp2", congest=4)
SERIES = ("fragmentation_series", "largest_free_block_series",
          "job_span_series")


def _scenarios(policy, strategy, topology, contention, **kw):
    kind, shape = TOPOLOGIES[topology]
    common = dict(policy=policy, alloc=strategy, contention=contention, **kw)
    return (rt.Scenario(trace=rt.SyntheticTrace(**TRACE),
                        topology=rt.Topology(kind, shape), **common),
            api.Scenario(trace=api.SyntheticTrace(**TRACE),
                         topology=api.Topology(kind, shape), **common))


def assert_same(a, b):
    assert set(a) == set(b)
    for k in b:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("contention", CONTENTIONS, ids=("off", "1-5"))
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("policy", POLICIES)
def test_machine_run_matches_jax_and_run_ref(policy, strategy, topology,
                                              contention):
    port_scn, jax_scn = _scenarios(policy, strategy, topology, contention)
    port = rt.run(port_scn, device="cpu")
    ref = api.run(jax_scn)
    oracle = api.run_ref(jax_scn)
    a = port.to_np()
    assert_same(a, ref.to_np())
    for k in ("ev_time", "ev_free", "ev_lfb"):
        np.testing.assert_array_equal(a[k], oracle.to_np()[k], err_msg=k)
    assert port.matches(ref, node_maps=True)
    assert port.matches(oracle, node_maps=True)
    assert port.summary() == ref.summary()
    assert set(port.summary()) >= {"mean_job_span", "mean_frag"}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_allocation_series_match_jax(strategy):
    port_scn, jax_scn = _scenarios("backfill", strategy, "dragonfly", (1, 5))
    a, b = rt.run(port_scn, device="cpu").to_np(), api.run(jax_scn).to_np()
    for name in SERIES:
        for x, y in zip(getattr(metrics, name)(a),
                        getattr(jax_metrics, name)(b)):
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert metrics.alloc_summary(a) == jax_metrics.alloc_summary(b)


def test_simple_without_contention_equals_scalar_mode():
    port_scn, _ = _scenarios("backfill", "simple", "dragonfly", None)
    machine = rt.run(port_scn, device="cpu").to_np()
    scalar = rt.run(port_scn.with_(topology=None, alloc=None),
                    device="cpu").to_np()
    for k in scalar:
        np.testing.assert_array_equal(machine[k], scalar[k], err_msg=k)
    with pytest.raises(ValueError, match="no event log"):
        metrics.fragmentation_series(scalar)


def test_preempt_under_contiguous_reaches_the_fallback():
    """Preempt's reclaim test counts nodes, so a start after a preemption
    may find no free run that fits and take scattered nodes."""
    port_scn, jax_scn = _scenarios("preempt", "contiguous", "linear", (1, 5))
    out = rt.run(port_scn, device="cpu").to_np()
    assert_same(out, api.run(jax_scn).to_np())
    v = out["valid"]
    need, first, asum = (out[k][v].astype(np.int64)
                         for k in ("nodes", "alloc_first", "alloc_sum"))
    scattered = asum != need * first + need * (need + 1) // 2
    assert scattered.any()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_max_events_cut_matches_jax(strategy):
    port_scn, jax_scn = _scenarios("bestfit", strategy, "mesh2d", (1, 5),
                                   max_events=77)
    assert_same(rt.run(port_scn, device="cpu").to_np(),
                api.run(jax_scn).to_np())


@pytest.mark.parametrize("strategy,batched", [
    ("simple", True), ("spread", True), ("contiguous", False),
    ("topo", False)])
def test_backfill_pass_and_cap_reads_follow_the_strategy(strategy, batched):
    """Backfill batches only under the free counter's cap; ``contiguous``
    reads its cap once a start, and no other strategy reads it at all."""
    port_scn, _ = _scenarios("backfill", strategy, "dragonfly", None)
    engine.reset_counters()
    out = rt.run(port_scn, device="cpu").to_np()
    assert (engine.counters["max_walks_per_event"] <= 1) == batched
    starts = int(out["valid"].sum())
    reads = engine.counters["cap_reads"]
    assert reads == (starts if strategy == "contiguous" else 0)
