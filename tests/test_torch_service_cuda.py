"""The port's what-if planner on the card, held to the same planner on the
CPU.

One query of each family (a placement over the three queues, an
``add_nodes`` grid, an MTBF grid) against ``demo_fleet``: the answer of a
``CapacityPlanner(device="cuda")`` equals the ``device="cpu"`` planner's
byte for byte (``canonical_dumps``, ``cache.entries`` dropped), and the
card's answer launched the batched ``queue_select`` entries.  They need a
CUDA device and skip without one; the file imports neither JAX nor the JAX
package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_service_cuda.py
"""

import json

import pytest
import torch

import repro_torch as rt
from repro_torch import service
from repro_torch.kernels.queue_select import ops

QUERIES = {
    "placement": service.WhatIfQuery(
        kind="placement", job=service.JobRequest(submit=0, runtime=400,
                                                 nodes=16)),
    "capacity": service.WhatIfQuery(
        kind="capacity", queue="batch",
        deltas=tuple(service.ScenarioDelta(add_nodes=d) for d in (0, 64))),
    "reliability": service.WhatIfQuery(
        kind="reliability", queue="flaky", mtbf_grid=(500e3, 2e6),
        objective=service.Objective(metric="goodput", goal="max")),
}


def _answer(query, device):
    rt.reset_cache_stats(clear=True)
    planner = service.CapacityPlanner(service.demo_fleet(), device=device)
    doc = json.loads(service.canonical_dumps(planner.answer(query)))
    doc["cache"].pop("entries")
    return service.canonical_dumps(doc)


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(QUERIES))
def test_planner_on_card_equals_cpu(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    query = QUERIES[family]
    ops.reset_launches()
    card = _answer(query, "cuda")
    assert ops.queue_select.batch_launches > 0
    assert card == _answer(query, "cpu")
