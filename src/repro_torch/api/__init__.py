"""Scenario specs, ``run()``, ``run_ref()``, ``sweep()`` and ``Result`` of
the PyTorch port, and the standalone workflow engine's entry points."""

from repro_torch.api.result import Result, simresult_to_np
from repro_torch.api.run import build_jobset, build_machine, run, run_ref
from repro_torch.api.scenario import (
    ArrayTrace, InjectedTrace, Multicluster, Scenario, SwfTrace,
    SyntheticTrace, Topology, WorkflowTrace, as_trace_spec,
)
from repro_torch.api.sweep import (
    SweepCacheStats, SweepResult, cache_stats, reset_cache_stats, sweep,
)
from repro_torch.core.parallel import (
    simulate_alloc_sweep, simulate_ensemble, simulate_multicluster,
    stack_jobsets,
)
from repro_torch.malleable import MalleableModel
from repro_torch.reliability import FailureModel
from repro_torch.serving import AutoscalePolicy, ServiceClass, ServiceTrace
from repro_torch.core.workflow import (
    WF_POLICY_IDS, critical_path_length, make_taskset, simulate_workflow,
    simulate_workflow_ensemble, stack_tasksets, workflow_result_np,
)

__all__ = ["ArrayTrace", "AutoscalePolicy", "FailureModel",
           "InjectedTrace", "MalleableModel", "Multicluster", "Result",
           "Scenario", "ServiceClass", "ServiceTrace", "SwfTrace",
           "SweepCacheStats", "SweepResult", "SyntheticTrace", "Topology",
           "WF_POLICY_IDS",
           "WorkflowTrace", "as_trace_spec", "build_jobset", "build_machine",
           "cache_stats", "critical_path_length", "make_taskset",
           "reset_cache_stats", "run", "run_ref", "simresult_to_np",
           "simulate_alloc_sweep", "simulate_ensemble",
           "simulate_multicluster", "simulate_workflow",
           "simulate_workflow_ensemble", "stack_jobsets", "stack_tasksets",
           "sweep", "workflow_result_np"]
