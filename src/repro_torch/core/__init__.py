"""Job table, policies, event engine (one-shot, conservative window and
lockstep), ensembles and multicluster windows, metrics and the standalone
workflow engine of the PyTorch port.

The engine's and the parallel modes' names resolve on first use (PEP 562):
``repro_torch.alloc`` imports ``core.jobs``, and the engine imports
``repro_torch.alloc``, so importing them here eagerly would be circular.
"""

import importlib

from repro_torch.core.workflow import (  # noqa: F401
    WF_POLICY_IDS, TaskSet, WorkflowState, critical_path_length,
    make_taskset, simulate_workflow, simulate_workflow_ensemble,
    stack_tasksets, workflow_result_np,
)

_LAZY = {
    "engine": ("make_alloc_ctx", "next_event_time", "policies_id",
               "simulate", "simulate_batch", "simulate_window",
               "simulate_window_batch"),
    "parallel": ("MulticlusterResult", "multicluster_result_np",
                 "simulate_alloc_sweep", "simulate_ensemble",
                 "simulate_multicluster", "stack_jobsets"),
}
_HOME = {name: mod for mod, names in _LAZY.items() for name in names}


def __getattr__(name: str):
    if name in _HOME:
        return getattr(importlib.import_module(
            f"repro_torch.core.{_HOME[name]}"), name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute "
                         f"{name!r}")
