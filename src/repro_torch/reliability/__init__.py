"""Node failures of the PyTorch port (DESIGN.md §15).

Counterpart of ``repro.reliability``: a frozen :class:`FailureModel`
materializes deterministic seeded failure/repair streams, which the
engine consumes from the host through :func:`make_fail_ctx`.  A killed
job requeues (with checkpoint rework) or aborts; ``failures=None`` runs
the engine without the stream.
"""

from repro_torch.reliability.model import (
    ABORT, FAIL, REPAIR, REQUEUE, REQUEUE_IDS, REQUEUE_NAMES,
    FailCtx, FailureModel, FailureTrace, make_fail_ctx, merge_stream,
)

__all__ = [
    "ABORT", "FAIL", "REPAIR", "REQUEUE", "REQUEUE_IDS", "REQUEUE_NAMES",
    "FailCtx", "FailureModel", "FailureTrace", "make_fail_ctx",
    "merge_stream",
]
