"""Job table, policies, event engine, metrics and the standalone workflow
engine of the PyTorch port."""

from repro_torch.core.workflow import (  # noqa: F401
    WF_POLICY_IDS, TaskSet, WorkflowState, critical_path_length,
    make_taskset, simulate_workflow, simulate_workflow_ensemble,
    stack_tasksets, workflow_result_np,
)
