"""PyTorch / CUDA port of the scheduling simulator, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing of
it.  It carries the single-cluster engine with the six policies (fcfs, sjf,
ljf, bestfit, backfill, preempt), in scalar-counter mode or on a machine
(``Topology``: linear, mesh2d, dragonfly) under four placement strategies
(simple, contiguous, spread, topo) with an optional contention model, on
job tables with or without workflow dependencies (``WorkflowTrace``), under
node failures (``FailureModel``), open-arrival serving (``ServiceTrace``)
and malleable jobs (``MalleableModel``), whose every selection runs the
``queue_select`` CUDA kernel on a CUDA device; the
standalone multi-resource workflow engine (``simulate_workflow``, paper
§3, and ``simulate_workflow_ensemble``, a stack of workflows in lockstep),
whose selections run the same kernel; conservative windows
(``simulate_window``), multicluster runs with migration
(``Multicluster``, the clusters' windows in lockstep) and the crash-safe
streaming replay of archive traces (``repro_torch.replay``); the host
oracle (``run_ref``, ``repro_torch.refsim``) that validates any run; the
what-if capacity-planning service (``repro_torch.service``: queries
lowered onto ``sweep``, candidate jobs through ``InjectedTrace``, an HTTP
front end); the
dense and rwkv LM serving path (``repro_torch.launch.serve``), whose
prefill runs the ``flash_attention`` (or ``linattn_scan``) CUDA kernel in
every layer; and their training (``Trainer``, ``repro_torch.launch.train``:
the chunked LM loss through the differentiable blockwise attention and
WKV, AdamW, int8 gradient compression, a deterministic token pipeline,
checkpoints with rollback and replay):

    import repro_torch as rt

    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=500, kind="sdsc_sp2"),
                      total_nodes=128, policy="backfill")
    res = rt.run(scn)            # on cuda; device="cpu" for the plain path
    res.to_np(), res.summary()
    assert res.matches(rt.run_ref(scn))   # the host oracle, bit-exact
    grid = rt.sweep(scn, axes={"policy": ("fcfs", "backfill"),
                               "total_nodes": (128, 256)})
    topo = scn.with_(total_nodes=None, topology=rt.Topology.dragonfly(16, 8))
    grid = rt.sweep(topo, axes={"alloc": ("simple", "topo"),
                                "contention": (None, (1, 5))})
    dag = rt.Scenario(trace=rt.WorkflowTrace(kind="galactic",
                                             params=(("tiles", 4),)),
                      total_nodes=128, policy="fcfs")
    rt.run(dag)["ready"]     # max(submit, last dependency's finish)
    rel = scn.with_(failures=rt.FailureModel(
        mtbf=50e3, horizon=2**19, max_failures=2048, requeue="abort"))
    rt.run(rel).summary()["goodput"]
    web = rt.Scenario(trace=rt.ServiceTrace(
        horizon=2**16, rate=0.05, max_jobs=4096,
        autoscale=rt.AutoscalePolicy(48, 8)), total_nodes=64)
    rt.sweep(web, axes={"trace.rate": (0.01, 0.05)})   # one bucket
    mal = scn.with_(malleable=rt.MalleableModel(
        param=0.1, max_width=16, mode="elastic", interval=64))
    rt.sweep(mal, axes={"malleable.param": (0.05, 0.5)})  # one bucket
    multi = rt.Scenario(trace=(rt.SyntheticTrace(kind="das2", seed=0),
                               rt.SyntheticTrace(kind="das2", seed=1)),
                        total_nodes=(144, 64), policy="backfill",
                        multicluster=rt.Multicluster(window=3600))
    rt.run(multi)["migrated"]
    cfg = rt.get_config("llama3.2-3b").reduced()
    tr = rt.Trainer(cfg, rt.AdamWConfig(lr=1e-3),
                    rt.TrainerConfig(steps=8, accum=2),
                    rt.SyntheticTokens(cfg.vocab, batch=4, seq=32))
    tr.run()["history"]      # [{"step", "loss", "dt"}], on cuda

A sweep runs each static bucket of its grid as one ensemble
(``simulate_ensemble``), whose members advance in lockstep and share each
batched launch of the ``queue_select`` kernel.
"""

from repro_torch.api import (
    WF_POLICY_IDS, ArrayTrace, AutoscalePolicy, FailureModel,
    InjectedTrace, MalleableModel, Multicluster, Result,
    Scenario, ServiceClass, ServiceTrace, SwfTrace, SweepCacheStats,
    SweepResult, SyntheticTrace, Topology, WorkflowTrace, cache_stats,
    critical_path_length, make_taskset, reset_cache_stats, run, run_ref,
    simulate_alloc_sweep, simulate_ensemble, simulate_multicluster,
    simulate_workflow, simulate_workflow_ensemble, stack_jobsets,
    stack_tasksets, sweep, workflow_result_np,
)
from repro_torch.configs.base import get_config
from repro_torch.core.engine import simulate, simulate_window
from repro_torch.data.pipeline import MemmapTokens, SyntheticTokens
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["AdamWConfig", "ArrayTrace", "AutoscalePolicy", "FailureModel",
           "InjectedTrace", "MalleableModel", "MemmapTokens", "Multicluster",
           "Result",
           "Scenario", "ServiceClass", "ServiceTrace", "SwfTrace",
           "SweepCacheStats", "SweepResult", "SyntheticTokens",
           "SyntheticTrace", "Topology", "Trainer", "TrainerConfig",
           "WF_POLICY_IDS",
           "WorkflowTrace", "cache_stats", "critical_path_length",
           "get_config", "make_taskset", "reset_cache_stats", "run", "run_ref",
           "simulate",
           "simulate_alloc_sweep", "simulate_ensemble",
           "simulate_multicluster", "simulate_window", "simulate_workflow",
           "simulate_workflow_ensemble", "stack_jobsets", "stack_tasksets",
           "sweep", "workflow_result_np"]
