"""Carry job tables and simulation state between numpy and the port.

The tests hand the identical job table and mid-run state to both engines:
``{name: np.ndarray}`` dicts read off the reference's ``JobSet`` /
``SimState`` go in through :func:`jobset_from_numpy` and
:func:`simstate_from_numpy`, and :func:`to_numpy` turns the port's objects
back into such dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.jobs import (
    JOB_FIELDS, STATE_SCALARS, STATE_TENSORS, JobSet, SimState,
)


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def jobset_from_numpy(fields: Dict[str, np.ndarray], device) -> JobSet:
    """A ``JobSet`` from the six job columns (int32, ``valid`` bool)."""
    return JobSet(**{
        f: _tensor(fields[f], device, bool if f == "valid" else np.int32)
        for f in JOB_FIELDS})


def simstate_from_numpy(fields: Dict[str, np.ndarray], device) -> SimState:
    """A ``SimState`` from the scalar-counter state fields: the per-job
    int32 columns and the ``clock``/``free``/``n_events`` scalars."""
    return SimState(
        **{f: _tensor(fields[f], device, np.int32) for f in STATE_TENSORS},
        **{f: int(fields[f]) for f in STATE_SCALARS})


def to_numpy(obj) -> Dict[str, np.ndarray]:
    """Any of the port's dataclasses (``JobSet``, ``SimState``,
    ``SimResult``) as ``{field: np.ndarray}``; scalars become 0-d int32."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v, dtype=np.int32))
    return out
