"""The port's host oracle (``repro_torch.refsim``, ``rt.run_ref``) against
the JAX package's, on the CPU.

``repro_torch.run_ref(s)`` must equal ``repro.api.run_ref(s)`` key by key
and dtype by dtype (the kill log entry by entry), and its ``summary()`` the
reference's, on every scenario family the port runs: the six policies on a
synthetic trace and on ``tests/data/tiny.swf``, machines under the four
strategies with contention, DAGs, requeue/abort/checkpoint failures,
serving with the autoscaler, moldable and elastic malleable jobs.  On the
same grid ``rt.run(s, device="cpu").matches(rt.run_ref(s))`` holds, and the
engine equals the oracle on every per-job column the oracle returns.
``simulate_workflow_reference`` and ``replay_reference`` equal their JAX
counterparts, and the oracle shares no code with the engine or the kernels.
"""

import os
import pathlib
import re

import numpy as np
import pytest
from _torch_streams import diff, jax_spec, same_summary

import repro_torch as rt
from repro import api
from repro.refsim import replay_reference as jax_replay_reference
from repro.refsim.workflow import (
    simulate_workflow_reference as jax_workflow_reference,
)
from repro_torch.refsim import (
    replay_reference, simulate_reference, simulate_workflow_reference,
)
from repro_torch.traces import workflows as TW

TINY_SWF = os.path.join(os.path.dirname(__file__), "data", "tiny.swf")
POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
ALLOCS = ("simple", "contiguous", "spread", "topo")
PORT = pathlib.Path(rt.__file__).resolve().parent

SDSC = rt.SyntheticTrace(n_jobs=200, seed=11, kind="sdsc_sp2", congest=4)
SMALL = rt.SyntheticTrace(n_jobs=120, seed=5, congest=4)
DAG = rt.WorkflowTrace(kind="galactic", params=(("tiles", 2), ("width", 8)))
SERVICE = rt.ServiceTrace(
    rate=0.06, horizon=1500, seed=7, max_jobs=256,
    classes=(rt.ServiceClass("small", nodes=1, mean_runtime=30, slo_wait=40),
             rt.ServiceClass("big", nodes=4, mean_runtime=120,
                             dist="exponential", slo_wait=200, weight=0.3)),
    autoscale=rt.AutoscalePolicy(up_threshold=6, down_threshold=1,
                                 min_nodes=4, max_nodes=16, step=2,
                                 interval=50, max_ticks=64))
MOLDABLE = rt.MalleableModel(curve="amdahl", param=0.2, min_width=1,
                             max_width=8, mode="moldable")
ELASTIC = rt.MalleableModel(curve="power", param=0.7, min_width=1,
                            max_width=8, mode="elastic", interval=30,
                            max_ticks=64, shrink_threshold=8,
                            grow_threshold=2, step=2)


def _failures(requeue="requeue", **kw):
    kw.setdefault("checkpoint_interval", 0)
    return rt.FailureModel(mtbf=1000.0, seed=4, mean_repair=40, horizon=2000,
                           max_failures=128, requeue=requeue, **kw)


def _trace(n=60, seed=1):
    rng = np.random.default_rng(seed)
    return rt.ArrayTrace.from_dict(dict(
        submit=rng.integers(0, 400, n), runtime=rng.integers(5, 80, n),
        nodes=rng.integers(1, 6, n), estimate=rng.integers(5, 100, n)))


DRAGONFLY = rt.Topology.dragonfly(4, 8)
MESH = rt.Topology.mesh2d(4, 4)
SCENARIOS = {
    **{f"scalar_{p}": rt.Scenario(trace=SDSC, total_nodes=128, policy=p)
       for p in POLICIES},
    **{f"swf_{p}": rt.Scenario(trace=rt.SwfTrace(TINY_SWF), total_nodes=64,
                               policy=p) for p in POLICIES},
    **{f"dragonfly_{a}": rt.Scenario(trace=SMALL, topology=DRAGONFLY,
                                     policy="backfill", alloc=a,
                                     contention=(1, 5)) for a in ALLOCS},
    "mesh2d_fcfs_topo": rt.Scenario(trace=SMALL, topology=MESH,
                                    policy="fcfs", alloc="topo"),
    "preempt_contiguous": rt.Scenario(trace=SMALL, topology=DRAGONFLY,
                                      policy="preempt", alloc="contiguous"),
    "dag_fcfs": rt.Scenario(trace=DAG, total_nodes=16, policy="fcfs"),
    "dag_backfill": rt.Scenario(trace=DAG, total_nodes=16,
                                policy="backfill"),
    "dag_dragonfly": rt.Scenario(trace=DAG, topology=DRAGONFLY,
                                 policy="bestfit", alloc="topo",
                                 contention=(1, 5)),
    "requeue": rt.Scenario(trace=_trace(), total_nodes=16,
                           policy="backfill", failures=_failures()),
    "abort": rt.Scenario(trace=_trace(), total_nodes=16, policy="fcfs",
                         failures=_failures("abort")),
    "checkpoint": rt.Scenario(trace=_trace(), total_nodes=16, policy="sjf",
                              failures=_failures(checkpoint_interval=20,
                                                 restart_overhead=5)),
    "requeue_mesh2d": rt.Scenario(trace=_trace(), topology=MESH,
                                  policy="backfill", alloc="contiguous",
                                  failures=_failures()),
    "dag_abort": rt.Scenario(trace=DAG, total_nodes=16, policy="fcfs",
                             failures=_failures("abort")),
    "serving": rt.Scenario(trace=SERVICE, total_nodes=16, policy="fcfs"),
    "serving_mesh2d": rt.Scenario(trace=SERVICE, topology=MESH,
                                  policy="sjf", alloc="simple"),
    "moldable": rt.Scenario(trace=SMALL, total_nodes=32, policy="backfill",
                            malleable=MOLDABLE),
    "elastic": rt.Scenario(trace=SMALL, total_nodes=32, policy="fcfs",
                           malleable=ELASTIC),
    "elastic_mesh2d": rt.Scenario(trace=SMALL,
                                  topology=rt.Topology.mesh2d(4, 8),
                                  policy="backfill", alloc="contiguous",
                                  malleable=ELASTIC),
    "elastic_failures": rt.Scenario(trace=SMALL, total_nodes=32,
                                    policy="backfill", malleable=ELASTIC,
                                    failures=_failures()),
}
# the engine's columns the oracle returns in another form: the whole event
# log (the engine's is cut to n_events) and the padding mask
NOT_PER_JOB = ("valid", "ev_time", "ev_free", "ev_lfb", "kill_log")


def _assert_same_dict(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "kill_log":
            assert got[k] == w
            continue
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_ref_equals_jax_run_ref(name):
    scn = SCENARIOS[name]
    got = rt.run_ref(scn)
    want = api.run_ref(jax_spec(scn))
    assert got.backend == "ref" and got.jobs is None
    _assert_same_dict(got.to_np(), want.to_np())
    assert same_summary(got.summary(), want.summary())


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_matches_run_ref(name):
    scn = SCENARIOS[name]
    res, ref = rt.run(scn, device="cpu"), rt.run_ref(scn)
    assert res.backend == "torch"
    assert res.matches(ref, node_maps=scn.topology is not None)
    assert ref.matches(res)
    keys = [k for k in ref.to_np() if k not in NOT_PER_JOB]
    assert diff(res.to_np(), ref.to_np(), keys) == []


@pytest.mark.parametrize("gen,policy,pools", [
    ("galactic", "fcfs", (64, 1 << 20)), ("galactic", "cpath", (8, 4096)),
    ("sipht", "fcfs_fit", (8, 8192)), ("random", "fcfs_fit", (4, 4096)),
    ("forkjoin", "fcfs", (3, 8192))])
def test_simulate_workflow_reference_equals_jax(gen, policy, pools):
    wf = {"galactic": lambda: TW.galactic_like(3, 8, seed=2),
          "sipht": lambda: TW.sipht_like(20, seed=3),
          "random": lambda: TW.random_layered(80, 8, seed=4),
          "forkjoin": lambda: TW.fork_join(6, 3, seed=5)}[gen]()
    prio = (rt.critical_path_length(wf["exec_time"], wf["dep_pairs"])
            if policy == "cpath" else None)
    args = (wf["exec_time"], wf["resources"], wf["dep_pairs"],
            np.asarray(pools), policy)
    _assert_same_dict(simulate_workflow_reference(*args, priority=prio),
                      jax_workflow_reference(*args, priority=prio))


@pytest.mark.parametrize("case", ("scalar", "machine", "failures",
                                  "beyond_int32"))
def test_replay_reference_equals_jax(case):
    trace = dict(SDSC.materialize())
    kw = dict(total_nodes=128)
    if case == "machine":
        kw = dict(total_nodes=128, alloc="topo", contention=(1, 4))
        machine = rt.Topology.dragonfly(16, 8)
        got = replay_reference(trace, "backfill",
                               machine=machine.build("cpu"), **kw)
        want = jax_replay_reference(trace, "backfill",
                                    machine=jax_spec(machine).build(), **kw)
    else:
        if case == "failures":
            kw["failures"] = _failures().materialize(128)
        if case == "beyond_int32":
            # past int32 even after the rebase of submit to 0
            trace["submit"] = trace["submit"].astype(np.int64) * 200_000
        got = replay_reference(trace, "backfill", **kw)
        if "failures" in kw:
            kw["failures"] = jax_spec(_failures()).materialize(128)
        want = jax_replay_reference(trace, "backfill", **kw)
    _assert_same_dict(got, want)
    if case == "beyond_int32":
        assert got["finish"].max() > 2**31


def test_simulate_reference_takes_a_machine_or_its_host_dict():
    trace = SMALL.materialize()
    machine = DRAGONFLY.build("cpu")
    a = simulate_reference(trace, "backfill", total_nodes=32,
                           machine=machine, alloc="spread")
    b = simulate_reference(trace, "backfill", total_nodes=32,
                           machine=machine.to_host(), alloc="spread")
    _assert_same_dict(a, b)


def test_run_ref_takes_policy_and_alloc_ids():
    by_name = rt.run_ref(SCENARIOS["dragonfly_topo"])
    by_id = rt.run_ref(SCENARIOS["dragonfly_topo"].with_(policy=4, alloc=3))
    _assert_same_dict(by_name.to_np(), by_id.to_np())


def test_run_ref_refuses_multicluster_as_the_reference():
    scn = SCENARIOS["scalar_fcfs"]
    object.__setattr__(scn := scn.with_(), "multicluster", object())
    with pytest.raises(ValueError, match="no multicluster mode"):
        rt.run_ref(scn)


@pytest.mark.parametrize("path", ["refsim/__init__.py", "refsim/sim.py",
                                  "refsim/workflow.py", "alloc/host.py"])
def test_oracle_shares_no_code_with_the_engine(path):
    """The oracle is a second implementation: it imports neither the
    engine, its policies and ensembles, nor a kernel."""
    text = (PORT / path).read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", text, re.M)
    assert imports
    for mod in imports:
        assert not re.search(r"\b(engine|policies|parallel|kernels)\b", mod), \
            (path, mod)
