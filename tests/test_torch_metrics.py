"""The port's metrics (``repro_torch.core.metrics``) against the JAX
package's (``repro.core.metrics``), on the same results.

The port keeps its own copy of the step series (occupancy, active jobs,
queue length) and of their sampling onto a grid; fed the canonical result
dicts of the same scenario, both must give the same arrays exactly.
"""

import numpy as np
import pytest

import repro_torch as rt
from repro import api
from repro.core import metrics as jax_metrics
from repro_torch.core import metrics

SERIES = ("occupancy_series", "active_jobs_series", "queue_length_series")


@pytest.fixture(scope="module", params=[("fcfs", "das2", 400),
                                        ("backfill", "sdsc_sp2", 128),
                                        ("preempt", "sdsc_sp2", 128)],
                ids=lambda p: f"{p[1]}-{p[0]}")
def results(request):
    policy, kind, nodes = request.param
    spec = dict(n_jobs=200, seed=5, kind=kind, congest=4)
    port = rt.run(rt.Scenario(trace=rt.SyntheticTrace(**spec),
                              total_nodes=nodes, policy=policy), device="cpu")
    ref = api.run(api.Scenario(trace=api.SyntheticTrace(**spec),
                               total_nodes=nodes, policy=policy))
    return port.to_np(), ref.to_np()


@pytest.mark.parametrize("name", SERIES)
def test_series_match_jax(results, name):
    port, ref = results
    t, v = getattr(metrics, name)(port)
    t_ref, v_ref = getattr(jax_metrics, name)(ref)
    assert t.dtype == t_ref.dtype and v.dtype == v_ref.dtype
    np.testing.assert_array_equal(t, t_ref)
    np.testing.assert_array_equal(v, v_ref)
    assert len(t) > 10


@pytest.mark.parametrize("name", SERIES)
def test_sample_series_matches_jax(results, name):
    port, ref = results
    t, v = getattr(metrics, name)(port)
    grid = np.linspace(-10, t[-1] + 10, 97)
    got = metrics.sample_series(t, v, grid)
    want = jax_metrics.sample_series(*getattr(jax_metrics, name)(ref), grid)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_step_series_matches_jax():
    rng = np.random.default_rng(3)
    times = rng.integers(0, 50, 200)      # many duplicate timestamps
    deltas = rng.integers(-5, 6, 200)
    for got, want in zip(metrics.step_series(times, deltas),
                         jax_metrics.step_series(times, deltas)):
        np.testing.assert_array_equal(got, want)


def test_occupancy_never_exceeds_the_machine(results):
    port, _ = results
    _, v = metrics.occupancy_series(port)
    assert v.min() >= 0 and v[-1] == 0
    _, q = metrics.queue_length_series(port)
    assert q.min() >= 0 and q[-1] == 0
