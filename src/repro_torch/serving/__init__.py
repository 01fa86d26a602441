"""Online serving of the PyTorch port (DESIGN.md §16).

Counterpart of ``repro.serving``: a frozen :class:`ServiceTrace`
materializes deterministic per-class request streams with per-request SLO
deadlines, and a queue-pressure :class:`AutoscalePolicy` drives a
deterministic capacity-tick stream, which the engine consumes from the
host through :func:`make_svc_ctx`.  ``service=None`` runs the engine
without the subsystem.
"""

from repro_torch.serving.model import (
    AutoscalePolicy, ServiceClass, ServicePlan, ServiceTrace, SvcCtx,
    make_svc_ctx,
)

__all__ = [
    "AutoscalePolicy", "ServiceClass", "ServicePlan", "ServiceTrace",
    "SvcCtx", "make_svc_ctx",
]
