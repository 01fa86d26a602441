"""Malleable jobs of the PyTorch port (DESIGN.md §17).

Counterpart of ``repro.malleable``: a frozen :class:`MalleableModel`
materializes a per-job width/dilation table (:func:`materialize_plan`),
which the engine consumes from the host through :func:`make_mal_ctx`.
Jobs choose their width at dispatch (moldable) and, in elastic mode, grow
and shrink at resize ticks and shed a failed node instead of dying;
``malleable=None`` runs rigid jobs.
"""

from repro_torch.malleable.model import (
    MalCtx, MalleableModel, MalleablePlan, make_mal_ctx, materialize_plan,
)

__all__ = ["MalCtx", "MalleableModel", "MalleablePlan", "make_mal_ctx",
           "materialize_plan"]
