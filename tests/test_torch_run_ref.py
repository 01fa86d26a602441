"""Whole runs of the port (on the CPU) against the host oracle and, on random
whole traces, against the JAX engine.

``repro_torch.run(scn, device="cpu")`` must equal ``repro.api.run_ref``
(the host reference simulator of ``repro.refsim``) on every key the oracle
returns, for the six policies on the archives' synthetic twins (300 jobs
on their machines: DAS-2's 400 nodes, SDSC-SP2's 128) and on
``tests/data/tiny.swf``.  A hypothesis property draws random traces of up
to 64 jobs, padded to one capacity so that the JAX engine compiles once a
policy, and holds the port to ``repro.api.run`` on them.
"""

import os

import numpy as np
import pytest

import repro_torch as rt
from _hypothesis_compat import given, settings, st
from repro import api

POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
TINY_SWF = os.path.join(os.path.dirname(__file__), "data", "tiny.swf")
COMPARED = ("start", "finish", "n_events", "makespan", "done", "wait",
            "ready", "valid")


def _assert_equal(port, other, keys=COMPARED):
    a, b = port.to_np(), other.to_np()
    for k in keys:
        if k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert port.matches(other)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("congest", (1, 4))
@pytest.mark.parametrize("kind,total_nodes", [("das2", 400),
                                              ("sdsc_sp2", 128)])
def test_synthetic_matches_run_ref(kind, total_nodes, congest, policy):
    spec = dict(n_jobs=300, seed=0, kind=kind, congest=congest)
    port = rt.run(rt.Scenario(trace=rt.SyntheticTrace(**spec),
                              total_nodes=total_nodes, policy=policy),
                  device="cpu")
    ref = api.run_ref(api.Scenario(trace=api.SyntheticTrace(**spec),
                                   total_nodes=total_nodes, policy=policy))
    _assert_equal(port, ref)


@pytest.mark.parametrize("policy", POLICIES)
def test_swf_matches_run_ref(policy):
    port = rt.run(rt.Scenario(trace=rt.SwfTrace(TINY_SWF), total_nodes=64,
                              policy=policy), device="cpu")
    ref = api.run_ref(api.Scenario(trace=api.SwfTrace(TINY_SWF),
                                   total_nodes=64, policy=policy))
    _assert_equal(port, ref)


def test_congested_policies_diverge():
    """The congested 300-job case gives the policies different schedules,
    so the oracle comparisons above test six policies, not one."""
    spec = rt.SyntheticTrace(n_jobs=300, seed=0, kind="sdsc_sp2", congest=4)
    starts = {p: rt.run(rt.Scenario(trace=spec, total_nodes=128, policy=p),
                        device="cpu")["start"].tobytes() for p in POLICIES}
    assert len(set(starts.values())) >= 5


CAPACITY = 64


@st.composite
def _whole_trace(draw):
    n = draw(st.integers(1, CAPACITY))
    ints = lambda lo, hi: st.lists(st.integers(lo, hi), min_size=n,  # noqa: E731
                                   max_size=n)
    return {"submit": draw(ints(0, 400)), "runtime": draw(ints(1, 120)),
            "nodes": draw(ints(1, 40)), "estimate": draw(ints(1, 240)),
            "priority": draw(ints(0, 3))}


@settings(max_examples=60, deadline=None, database=None)
@given(trace=_whole_trace(), policy=st.sampled_from(POLICIES),
       total_nodes=st.sampled_from((16, 32)))
def test_property_random_traces_match_jax(trace, policy, total_nodes):
    kw = dict(total_nodes=total_nodes, policy=policy, capacity=CAPACITY)
    port = rt.run(rt.Scenario(trace=rt.ArrayTrace(**trace), **kw),
                  device="cpu")
    ref = api.run(api.Scenario(trace=api.ArrayTrace(**trace), **kw))
    _assert_equal(port, ref, keys=("submit", "nodes", "runtime") + COMPARED)
