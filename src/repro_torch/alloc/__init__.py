"""Topology-aware node allocation of the PyTorch port (DESIGN.md §11).

Counterpart of ``repro.alloc``: a :class:`Machine` gives the cluster a
concrete shape (linear racks, 2-D mesh rows, dragonfly groups), the
engine's state carries a per-node occupancy map, and four placement
strategies decide which nodes each job gets:

====================  =====================================================
``simple``            first-fit scattered: timing-identical to the scalar
                      counter
``contiguous``        best-fit contiguous block; blocks under fragmentation
``spread``            round-robin across groups (maximizes span)
``topo``              pack fewest groups (minimizes span)
====================  =====================================================

An optional :class:`Contention` model dilates a job's runtime for each
extra group it spans.  The placers are plain PyTorch over ``[..., N]``
occupancy maps, so one call places a job for a solo run (``[N]``) or for
several ensemble members at once (``[M, N]``).
"""

from repro_torch.alloc.contention import Contention, dilate, dilate_host
from repro_torch.alloc.machine import Machine, dragonfly, linear, mesh2d
from repro_torch.alloc.strategies import (
    ALLOC_IDS, ALLOC_NAMES, CONTIGUOUS, SIMPLE, SPREAD, TOPO,
    alloc_fingerprint, alloc_id, canonical_id, free_count, group_span,
    largest_free_run, place, place_batch, placeable_cap,
)

__all__ = [
    "ALLOC_IDS", "ALLOC_NAMES", "CONTIGUOUS", "SIMPLE", "SPREAD", "TOPO",
    "Contention", "Machine", "alloc_fingerprint", "alloc_id", "canonical_id",
    "dilate", "dilate_host", "dragonfly", "free_count", "group_span",
    "largest_free_run", "linear", "mesh2d", "place", "place_batch",
    "placeable_cap",
]
