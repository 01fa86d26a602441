"""Scenario specs, ``run()``, ``sweep()`` and ``Result`` of the PyTorch port."""

from repro_torch.api.result import Result, simresult_to_np
from repro_torch.api.run import build_jobset, build_machine, run
from repro_torch.api.scenario import (
    ArrayTrace, Scenario, SwfTrace, SyntheticTrace, Topology, as_trace_spec,
)
from repro_torch.api.sweep import (
    SweepCacheStats, SweepResult, cache_stats, reset_cache_stats, sweep,
)
from repro_torch.core.parallel import (
    simulate_alloc_sweep, simulate_ensemble, stack_jobsets,
)

__all__ = ["ArrayTrace", "Result", "Scenario", "SwfTrace", "SweepCacheStats",
           "SweepResult", "SyntheticTrace", "Topology", "as_trace_spec",
           "build_jobset", "build_machine", "cache_stats",
           "reset_cache_stats", "run", "simresult_to_np",
           "simulate_alloc_sweep", "simulate_ensemble", "stack_jobsets",
           "sweep"]
