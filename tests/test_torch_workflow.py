"""The port's standalone workflow engine (paper §3) against the JAX pool
engine and the heap-based oracle, on the CPU.

``repro_torch.simulate_workflow`` must give ``workflow_result_np`` equal,
key by key and dtype by dtype, to ``repro.core.workflow``'s on every
generator under fcfs, fcfs_fit and cpath, and equal to
``repro.refsim.workflow.simulate_workflow_reference`` on start and finish;
the generators, the Listing 2 JSON codec and ``critical_path_length`` must
equal the JAX package's seed for seed.  Also: a task that can never fit,
the event cap, the refusals of ``make_taskset``, and the reference's
``INF_TIME`` priority corner (ROADMAP Queue 3).
"""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro_torch as rt
from repro.core import workflow as jwf
from repro.refsim.workflow import simulate_workflow_reference
from repro.traces import workflows as JW
from repro_torch.core import workflow as twf
from repro_torch.traces import workflows as TW

POOLS = np.array([16, 16384])
POLICIES = ("fcfs", "fcfs_fit", "cpath")
GENS = {
    "chain": lambda W, s: W.chain(15),
    "forkjoin": lambda W, s: W.fork_join(6, 3, seed=s),
    "montage": lambda W, s: W.montage_like(12, seed=s),
    "sipht": lambda W, s: W.sipht_like(20, seed=s),
    "galactic": lambda W, s: W.galactic_like(3, 8, seed=s),
    "random": lambda W, s: W.random_layered(80, 8, seed=s),
}


def run_three(wf, policy, pools=POOLS, priority=None, capacity=None,
              max_events=None):
    """(port, JAX, oracle) results of one workflow."""
    ts = rt.make_taskset(wf["exec_time"], wf["resources"], wf["dep_pairs"],
                         priority=priority, capacity=capacity, device="cpu")
    port = rt.workflow_result_np(ts, rt.simulate_workflow(
        ts, pools, rt.WF_POLICY_IDS[policy], max_events=max_events,
        device="cpu"))
    jts = jwf.make_taskset(wf["exec_time"], wf["resources"],
                           wf["dep_pairs"], priority=priority,
                           capacity=capacity)
    jax = jwf.workflow_result_np(jts, jwf.simulate_workflow(
        jts, pools, jwf.WF_POLICY_IDS[policy], max_events=max_events))
    ref = simulate_workflow_reference(
        wf["exec_time"], wf["resources"], wf["dep_pairs"], pools, policy,
        priority=priority)
    return port, jax, ref


def assert_same(a, b):
    assert set(a) == set(b)
    for k in b:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("gen", list(GENS))
def test_generators_equal_jax_seed_for_seed(gen):
    for seed in (0, 5, 9):
        a, b = GENS[gen](TW, seed), GENS[gen](JW, seed)
        assert set(a) == set(b)
        for k in ("exec_time", "resources"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert a["dep_pairs"] == b["dep_pairs"]


@pytest.mark.parametrize("gen", list(GENS))
@pytest.mark.parametrize("policy", POLICIES)
def test_pool_engine_matches_jax_and_oracle(gen, policy):
    wf = GENS[gen](TW, 5)
    prio = (rt.critical_path_length(wf["exec_time"], wf["dep_pairs"])
            if policy == "cpath" else None)
    port, jax, ref = run_three(wf, policy, priority=prio)
    assert_same(port, jax)
    n = len(ref["start"])
    assert port["done"][:n].all()
    np.testing.assert_array_equal(port["start"][:n], ref["start"])
    np.testing.assert_array_equal(port["finish"][:n], ref["finish"])


@pytest.mark.parametrize("policy", POLICIES)
def test_fig6_fig7_shapes_match_jax(policy):
    """Fig. 6's pools over a galactic DAG, Fig. 7's over a sipht DAG, with
    padded capacity."""
    for wf, pools in ((TW.galactic_like(4, 12, seed=4), np.array([64, 1 << 20])),
                      (TW.sipht_like(30, seed=30), np.array([8, 8192]))):
        prio = (rt.critical_path_length(wf["exec_time"], wf["dep_pairs"])
                if policy == "cpath" else None)
        cap = len(wf["exec_time"]) + 13
        port, jax, _ = run_three(wf, policy, pools, prio, capacity=cap)
        assert_same(port, jax)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(10, 60),
       policy=st.sampled_from(POLICIES))
def test_random_dags_match_jax_and_oracle(seed, n, policy):
    wf = TW.random_layered(n, max(n // 8, 2), seed=seed)
    prio = (rt.critical_path_length(wf["exec_time"], wf["dep_pairs"])
            if policy == "cpath" else None)
    port, jax, ref = run_three(wf, policy, priority=prio)
    assert_same(port, jax)
    m = len(ref["start"])
    np.testing.assert_array_equal(port["start"][:m], ref["start"])


@pytest.mark.parametrize("gen", list(GENS))
def test_critical_path_length_equals_jax(gen):
    wf = GENS[gen](TW, 3)
    got = rt.critical_path_length(wf["exec_time"], wf["dep_pairs"])
    want = jwf.critical_path_length(wf["exec_time"], wf["dep_pairs"])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_json_round_trip_equals_jax():
    wf = TW.montage_like(8, seed=1)
    text = TW.to_json(wf, POOLS)
    assert text == JW.to_json(JW.montage_like(8, seed=1), POOLS)
    wf2, pools2, policy = TW.from_json(text)
    np.testing.assert_array_equal(wf["exec_time"], wf2["exec_time"])
    np.testing.assert_array_equal(wf["resources"], wf2["resources"])
    assert sorted(wf["dep_pairs"]) == sorted(wf2["dep_pairs"])
    np.testing.assert_array_equal(pools2, POOLS)
    assert policy == "Static"


def test_paper_listing2_example():
    doc = """
    {"tasks": [
      {"id": 1, "execution_time": 100, "resources": {"cpu": 2, "memory": 1024}, "dependencies": []},
      {"id": 2, "execution_time": 150, "resources": {"cpu": 1, "memory": 512}, "dependencies": [1]},
      {"id": 3, "execution_time": 200, "resources": {"cpu": 1, "memory": 512}, "dependencies": [1]},
      {"id": 4, "execution_time": 300, "resources": {"cpu": 2, "memory": 1024}, "dependencies": [2, 3]}],
     "resources_available": {"cpu": 10, "memory": 8192},
     "scheduling_policy": "Static", "preemption": false}
    """
    wf, pools, _ = TW.from_json(doc)
    port, jax, ref = run_three(wf, "fcfs", pools=pools)
    assert_same(port, jax)
    assert port["makespan"] == 100 + 200 + 300
    np.testing.assert_array_equal(port["start"][:4], ref["start"])
    np.testing.assert_array_equal(port["ready"][:4], [0, 100, 100, 300])


@pytest.mark.parametrize("policy", POLICIES)
def test_a_task_that_never_fits_stays_waiting(policy):
    """The loop ends when nothing runs: the oversized task and its
    dependents are never done (under fcfs the blocked head holds back the
    rest of the queue too), and a ready time reads INF_TIME where a
    dependency never finished, as in the reference."""
    wf = {"exec_time": np.array([10, 20, 30, 5]),
          "resources": np.array([[1, 1], [64, 1], [1, 1], [1, 1]]),
          "dep_pairs": [(2, 1), (3, 0)]}
    port, jax, _ = run_three(wf, policy, pools=np.array([8, 8]))
    assert_same(port, jax)
    assert not port["done"][1] and not port["done"][2]
    assert port["done"][0]
    assert port["done"][3] == (policy != "fcfs")
    assert port["ready"][2] == twf.INF_TIME


def test_event_cap_and_default_priority():
    wf = TW.chain(12)
    for cap in (0, 3, 11):
        port, jax, _ = run_three(wf, "fcfs", max_events=cap)
        assert_same(port, jax)
        assert port["n_events"] == cap
    ts = rt.make_taskset(wf["exec_time"], wf["resources"], wf["dep_pairs"],
                         capacity=20, device="cpu")
    np.testing.assert_array_equal(ts.priority.numpy(), np.arange(20))
    assert ts.exec_time.numpy()[12:].tolist() == [1] * 8
    assert not ts.valid.numpy()[12:].any()


def test_make_taskset_refusals_and_dense_deps():
    with pytest.raises(ValueError, match="cycle"):
        rt.make_taskset([10, 10, 10], [[1, 1]] * 3, [(0, 1), (1, 2), (2, 0)],
                        device="cpu")
    with pytest.raises(ValueError, match="self"):
        rt.make_taskset([10], [[1, 1]], [(0, 0)], device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        rt.make_taskset([10, 10], [[1, 1]] * 2, [(0, 2)], device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        rt.make_taskset([10, 10], [[1, 1]] * 2, [], capacity=1, device="cpu")
    wf = TW.sipht_like(10, seed=1)
    ts = rt.make_taskset(wf["exec_time"], wf["resources"], wf["dep_pairs"],
                         capacity=24, device="cpu")
    jts = jwf.make_taskset(wf["exec_time"], wf["resources"], wf["dep_pairs"],
                           capacity=24)
    np.testing.assert_array_equal(ts.deps.numpy(), np.asarray(jts.deps))
    for f in ("exec_time", "resources", "valid", "priority"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(jts, f)), err_msg=f)


@pytest.mark.parametrize("policy", POLICIES)
def test_priorities_at_inf_time_follow_the_reference(policy):
    """ROADMAP Queue 3: the reference masks with ``where(ready, priority,
    INF_TIME)``, so a ready task whose priority reaches INF_TIME is no
    longer the masked minimum; the port takes the reference's form there
    and equals the JAX engine, where the oracle (a true minimum) differs."""
    wf = TW.fork_join(4, 2, seed=2)
    n = len(wf["exec_time"])
    prio = np.arange(n, dtype=np.int64)
    prio[1::2] = twf.INF_TIME + 3
    port, jax, ref = run_three(wf, policy, priority=prio)
    assert_same(port, jax)
    assert not np.array_equal(port["start"][:n], ref["start"])


def test_entry_points_default_to_cuda_and_take_names():
    wf = TW.chain(4)
    ts = rt.make_taskset(wf["exec_time"], wf["resources"], wf["dep_pairs"],
                         device="cpu")
    by_name = rt.simulate_workflow(ts, POOLS, "fcfs_fit", device="cpu")
    by_id = rt.simulate_workflow(ts, POOLS, rt.WF_POLICY_IDS["fcfs_fit"],
                                 device="cpu")
    np.testing.assert_array_equal(by_name.start.numpy(), by_id.start.numpy())
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rt.simulate_workflow(ts, POOLS)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rt.make_taskset(wf["exec_time"], wf["resources"], wf["dep_pairs"])
