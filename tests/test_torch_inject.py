"""``InjectedTrace`` of the PyTorch port against the JAX package's.

The what-if service appends candidate jobs to a queue's trace through
``InjectedTrace``.  These tests hold the port's spec to
``repro.api.InjectedTrace``: the materialized arrays (optional columns,
pair and dense dependencies), the static key, ``n_rows`` and the
validation messages; then ``run``, ``run_ref`` and a 2-point ``sweep`` of
injected scenarios (scalar, ``mesh2d``, with failures, on a workflow base
with pairs and with a dense matrix), each equal bit for bit to
``repro.api.run`` and ``repro.api.run_ref``.  Injected rows get no
dependency edges.
"""

import numpy as np
import pytest
import torch
from _torch_streams import assert_matches_jax, jax_spec

import repro_torch as rt
from repro import api
from repro_torch.api.run import build_jobset
from repro_torch.api.scenario import as_trace_spec
from repro_torch.core import jobs as jobs_mod


def _arrays(seed=0, n=24, estimate=False, priority=False, deps=None):
    rng = np.random.default_rng(seed)
    kw = dict(submit=rng.integers(0, 600, n), runtime=rng.integers(5, 90, n),
              nodes=rng.integers(1, 9, n))
    if estimate:
        kw["estimate"] = kw["runtime"] + rng.integers(0, 40, n)
    if priority:
        kw["priority"] = rng.integers(0, 5, n)
    if deps == "pairs":
        kw["deps"] = [(j, j - 1 - int(rng.integers(0, min(j, 3))))
                      for j in range(2, n, 3)]
    elif deps == "dense":
        m = np.zeros((n, n), dtype=bool)
        for j in range(3, n, 4):
            m[j, j - 2] = True
            m[j, j - 3] = True
        kw["deps"] = m
    return kw


BASES = {
    "synthetic": lambda: rt.SyntheticTrace(n_jobs=30, seed=2, kind="sdsc_sp2"),
    "generic_congest": lambda: rt.SyntheticTrace(n_jobs=25, seed=1, congest=3),
    "arrays_plain": lambda: rt.ArrayTrace(**_arrays()),
    "arrays_estimate_priority": lambda: rt.ArrayTrace(
        **_arrays(1, estimate=True, priority=True)),
    "arrays_pairs": lambda: rt.ArrayTrace(**_arrays(2, deps="pairs")),
    "arrays_dense": lambda: rt.ArrayTrace(**_arrays(3, deps="dense")),
    "workflow": lambda: rt.WorkflowTrace(kind="montage", seed=4),
}

JOBS = {
    "one": ((40, 120, 4),),
    "estimate": ((40, 120, 4, 200),),
    "priority": ((40, 120, 4, None, 7),),
    "three": ((0, 10, 1), (40, 120, 4, 150, 2), (900, 5, 8)),
}


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("jobs", sorted(JOBS))
def test_materialize_matches_jax(base, jobs):
    spec = rt.InjectedTrace(base=BASES[base](), jobs=JOBS[jobs])
    ref = jax_spec(spec)
    got, want = spec.materialize(), ref.materialize()
    assert sorted(got) == sorted(want)
    for k in got:
        if k == "deps":
            a, b = got[k], want[k]
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert [tuple(p) for p in a] == [tuple(p) for p in b]
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    if isinstance(spec.base, rt.ArrayTrace):   # keyed by identity
        assert spec.static_key() == ("inject", spec.base.static_key(),
                                     len(JOBS[jobs]))
        assert ref.static_key()[::2] == spec.static_key()[::2]
    else:
        assert spec.static_key() == ref.static_key()
    assert spec.n_rows == ref.n_rows
    assert spec.jobs == ref.jobs


def test_static_key_counts_jobs_not_values():
    base = rt.SyntheticTrace(n_jobs=30, kind="sdsc_sp2")
    a = rt.InjectedTrace(base=base, jobs=((0, 10, 1),))
    b = rt.InjectedTrace(base=base, jobs=((500, 99, 7, 120, 3),))
    c = rt.InjectedTrace(base=base, jobs=((0, 10, 1), (0, 10, 1)))
    assert a.static_key() == b.static_key() == (
        "inject", base.static_key(), 1)
    assert c.static_key() == ("inject", base.static_key(), 2)
    assert a != b and len({a, b}) == 2
    assert a == rt.InjectedTrace(base=base, jobs=([0, 10, 1],))
    assert rt.InjectedTrace(base=rt.SwfTrace("x.swf"),
                            jobs=((0, 1, 1),)).n_rows is None


BAD = {
    "service_base": (lambda m: m.ServiceTrace(horizon=100, rate=0.1),
                     ((0, 1, 1),)),
    "too_long": (lambda m: m.SyntheticTrace(n_jobs=5),
                 ((0, 1, 1, 1, 1, 1),)),
    "zero_runtime": (lambda m: m.SyntheticTrace(n_jobs=5), ((0, 0, 1),)),
    "zero_nodes": (lambda m: m.SyntheticTrace(n_jobs=5), ((0, 5, 0),)),
    "negative_submit": (lambda m: m.SyntheticTrace(n_jobs=5),
                        ((-1, 5, 1),)),
    "empty": (lambda m: m.SyntheticTrace(n_jobs=5), ()),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validation_errors_match_jax(case):
    make, jobs = BAD[case]
    with pytest.raises(ValueError) as want:
        api.InjectedTrace(base=make(api), jobs=jobs)
    with pytest.raises(ValueError) as got:
        rt.InjectedTrace(base=make(rt), jobs=jobs)
    assert str(got.value) == str(want.value)


def test_as_trace_spec_refuses_like_jax():
    with pytest.raises(TypeError) as want:
        api.as_trace_spec(42)
    with pytest.raises(TypeError) as got:
        as_trace_spec(42)
    assert str(got.value) == str(want.value)
    spec = rt.InjectedTrace(base=rt.SyntheticTrace(n_jobs=5),
                            jobs=((0, 1, 1),))
    assert as_trace_spec(spec) is spec
    assert rt.InjectedTrace(base={"submit": [0, 1], "runtime": [3, 4],
                                  "nodes": [1, 2]},
                            jobs=((0, 1, 1),)).n_rows == 3


CANDIDATES = ((50, 400, 8), (0, 100, 4, 150, None))


def _scenario(kind):
    if kind == "scalar":
        return rt.Scenario(trace=rt.SyntheticTrace(
            n_jobs=40, seed=0, kind="sdsc_sp2"), total_nodes=32,
            policy="backfill")
    if kind == "mesh2d":
        return rt.Scenario(trace=rt.SyntheticTrace(
            n_jobs=40, seed=1, kind="sdsc_sp2"),
            topology=rt.Topology.mesh2d(4, 8), alloc="contiguous",
            policy="sjf")
    if kind == "failures":
        return rt.Scenario(trace=rt.SyntheticTrace(
            n_jobs=40, seed=2, kind="sdsc_sp2"), total_nodes=32,
            policy="backfill", failures=rt.FailureModel(
                mtbf=300_000.0, seed=3, max_failures=64))
    if kind == "workflow":
        return rt.Scenario(trace=rt.WorkflowTrace(kind="montage", seed=4),
                           total_nodes=16, policy="fcfs")
    assert kind == "dense"
    return rt.Scenario(trace=rt.ArrayTrace(**_arrays(3, n=40, deps="dense")),
                       total_nodes=8, policy="backfill")


KINDS = ("scalar", "mesh2d", "failures", "workflow", "dense")


@pytest.mark.parametrize("kind", KINDS)
def test_run_and_run_ref_match_jax(kind):
    base = _scenario(kind)
    scn = base.with_(trace=rt.InjectedTrace(base=base.trace,
                                            jobs=CANDIDATES))
    res = rt.run(scn, device="cpu")
    assert_matches_jax(res)
    assert res.matches(rt.run_ref(scn), node_maps=scn.topology is not None)
    assert int(res.to_np()["valid"].sum()) == scn.trace.n_rows


@pytest.mark.parametrize("kind", KINDS)
def test_two_point_sweep_matches_jax(kind):
    """Two candidates of one count share a bucket, and the job-table
    cache keys on the spec's values: each point is its own run."""
    base = _scenario(kind)
    scn = base.with_(trace=rt.InjectedTrace(base=base.trace,
                                            jobs=CANDIDATES[:1]))
    grid = rt.sweep(scn, axes={"trace.jobs": (CANDIDATES[:1],
                                              CANDIDATES[1:])},
                    device="cpu")
    assert grid.n_compiles == 1 and len(grid) == 2
    starts = []
    for point, res in grid:
        one = scn.with_(**point)
        assert res.scenario == one
        assert_matches_jax(res, one, ref=False)
        assert res.matches(rt.run(one, device="cpu"))
        starts.append(res.to_np()["start"])
    assert not np.array_equal(*starts)


@pytest.mark.parametrize("kind", ("workflow", "dense"))
def test_injected_rows_get_no_edges(kind):
    base = _scenario(kind)
    scn = base.with_(trace=rt.InjectedTrace(base=base.trace,
                                            jobs=CANDIDATES))
    base_jobs = build_jobset(base, device="cpu")
    jobs = build_jobset(scn, device="cpu")
    sub = scn.trace.materialize()["submit"]
    n = len(sub)
    order = np.lexsort((np.arange(n), sub))
    rows = [int(np.nonzero(order == i)[0][0]) for i in (n - 2, n - 1)]
    J = jobs.capacity
    deps = jobs_mod.edge_list(jobs.dep_dst, jobs.dep_src, J)
    counts = jobs_mod.count_deps(deps, torch.ones(J, dtype=torch.bool))
    assert int(counts.sum()) == int((base_jobs.dep_dst < base_jobs.capacity)
                                    .sum())
    for r in rows:
        assert int(counts[r]) == 0
        real = jobs.dep_dst < J
        assert not bool((jobs.dep_src[real] == r).any())
