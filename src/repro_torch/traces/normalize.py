"""The streaming replay's trace normalization, shared by the replay runner
(``repro_torch.replay``) and the host oracle's ``replay_reference``.

It imports nothing of the engine, so the oracle stays a second
implementation."""

from __future__ import annotations

from typing import Dict

import numpy as np


def normalize_trace(trace: Dict[str, np.ndarray], total_nodes: int) -> dict:
    """``make_jobset``'s normalization, kept int64 and unguarded by the
    int32 horizon check (replay windows own overflow): rebase submit to 0,
    clamp runtime, estimate and nodes, sort by (submit, original index).
    A trace with dependencies is refused."""
    submit = np.asarray(trace["submit"], dtype=np.int64)
    n = submit.shape[0]
    submit = submit - (submit.min() if n else 0)
    runtime = np.maximum(np.asarray(trace["runtime"], dtype=np.int64), 1)
    estimate = (np.maximum(np.asarray(trace["estimate"], dtype=np.int64), 1)
                if trace.get("estimate") is not None else runtime.copy())
    nodes = np.clip(np.asarray(trace["nodes"], dtype=np.int64), 1,
                    total_nodes)
    priority = (np.asarray(trace["priority"], dtype=np.int64)
                if trace.get("priority") is not None
                else np.zeros(n, dtype=np.int64))
    if trace.get("deps") is not None:
        raise ValueError(
            "streaming replay drives dependency-free archive traces; "
            "workflow DAGs go through simulate/simulate_window directly")
    order = np.lexsort((np.arange(n), submit))
    return {
        "submit": submit[order], "runtime": runtime[order],
        "estimate": estimate[order], "nodes": nodes[order],
        "priority": priority[order],
    }
