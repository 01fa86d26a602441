"""What-if capacity-planning query service of the PyTorch port
(DESIGN.md §20).

Counterpart of ``repro.service``: a long-running process loads a *fleet*
of named queue :class:`~repro_torch.api.Scenario`\\ s once and answers
versioned, JSON-round-trippable :class:`WhatIfQuery` documents ("where
should this job run", "what happens to p99 wait if we add 64 nodes",
"which MTBF budget meets a goodput target") by lowering each query onto
the port's ``sweep``, on the card.  The answers equal the reference
planner's byte for byte (``canonical_dumps``), but for the process's
``cache.entries`` counter.

    from repro_torch import service

    planner = service.CapacityPlanner(service.demo_fleet())  # on cuda
    q = service.WhatIfQuery(kind="capacity", queue="batch",
                            deltas=(service.ScenarioDelta(add_nodes=64),))
    print(planner.answer(q)["recommendations"][0])

``python -m repro_torch.service --demo`` (or ``--fleet fleet.json``) serves
the same planner over stdlib HTTP; see :mod:`repro_torch.service.http`.
"""

from repro_torch.service.http import (
    WhatIfServer, demo_fleet, main, make_server,
)
from repro_torch.service.planner import (
    CapacityPlanner, UnknownQueueError, candidate_outcome, enriched_summary,
)
from repro_torch.service.query import (
    JobRequest, Objective, SCHEMA_VERSION, ScenarioDelta, SchemaError,
    WhatIfQuery, apply_delta, canonical_dumps, fleet_from_json,
    fleet_to_json, scenario_from_json, scenario_to_json,
)

__all__ = [
    "CapacityPlanner", "JobRequest", "Objective", "SCHEMA_VERSION",
    "ScenarioDelta", "SchemaError", "UnknownQueueError", "WhatIfQuery",
    "WhatIfServer", "apply_delta", "candidate_outcome", "canonical_dumps",
    "demo_fleet", "enriched_summary", "fleet_from_json", "fleet_to_json",
    "main", "make_server", "scenario_from_json", "scenario_to_json",
]
