"""Scenario specs, ``run()`` and ``Result`` of the PyTorch port."""

from repro_torch.api.result import Result, simresult_to_np
from repro_torch.api.run import build_jobset, run
from repro_torch.api.scenario import (
    ArrayTrace, Scenario, SwfTrace, SyntheticTrace, as_trace_spec,
)

__all__ = ["ArrayTrace", "Result", "Scenario", "SwfTrace", "SyntheticTrace",
           "as_trace_spec", "build_jobset", "run", "simresult_to_np"]
