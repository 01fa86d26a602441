"""Carry job tables, simulation state and model weights between numpy and
the port.

The tests hand the identical job table and mid-run state to both engines:
``{name: np.ndarray}`` dicts read off the reference's ``JobSet`` /
``SimState`` go in through :func:`jobset_from_numpy` and
:func:`simstate_from_numpy`, and :func:`to_numpy` turns the port's objects
back into such dicts.  LM weights cross as numpy trees:
:func:`lm_params_from_numpy` takes the JAX package's parameters (or the
seeded ones of :func:`numpy_lm_params`) into the port's ``LM``, and
:func:`set_rwkv_live_leaves` draws the rwkv leaves that the initializer
leaves at zero.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobs import (
    EDGE_FIELDS, JOB_COLUMNS, STATE_SCALARS, STATE_TENSORS, JobSet, SimState,
    machine_fields,
)
from repro_torch.models.lm import LM, param_defs
from repro_torch.sharding.rules import ParamDef, map_defs


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def jobset_from_numpy(fields: Dict[str, np.ndarray], device) -> JobSet:
    """A ``JobSet`` from the six job columns (int32, ``valid`` bool) and,
    where ``fields`` has them, the edge list ``dep_dst``/``dep_src``."""
    return JobSet(**{
        f: _tensor(fields[f], device, bool if f == "valid" else np.int32)
        for f in JOB_COLUMNS}, **{
        f: _tensor(fields[f], device, np.int32) for f in EDGE_FIELDS
        if fields.get(f) is not None})


def simstate_from_numpy(fields: Dict[str, np.ndarray], device) -> SimState:
    """A scalar-counter ``SimState`` from the per-job int32 columns and the
    ``clock``/``free``/``n_events`` scalars (no machine)."""
    return SimState(
        **{f: _tensor(fields[f], device, np.int32) for f in STATE_TENSORS},
        **{f: int(fields[f]) for f in STATE_SCALARS},
        **machine_fields(len(fields["jstate"]), 0, 0, device))


def _np(v) -> np.ndarray:
    return (v.cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, dtype=np.int32))


def to_numpy(obj) -> Dict[str, np.ndarray]:
    """Any of the port's dataclasses (``JobSet``, ``SimState``,
    ``SimResult``) as ``{field: np.ndarray}``; scalars become 0-d int32.
    A ``SimState`` gives its scalar-counter fields; a field that is
    ``None`` (a table's absent edge list) is left out."""
    if isinstance(obj, SimState):
        return {f: _np(getattr(obj, f))
                for f in STATE_TENSORS + STATE_SCALARS}
    return {f.name: _np(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def lm_params_from_numpy(tree, device) -> LM:
    """The port's LM parameters from a numpy tree of the JAX package's
    parameters (``jax.tree.map(np.asarray, params)``) or of
    :func:`numpy_lm_params`: the same names, shapes and dtypes, one tensor
    per leaf, on ``device``."""
    def convert(t):
        if isinstance(t, dict):
            return {k: convert(x) for k, x in t.items()}
        return torch.from_numpy(np.array(t)).to(device)
    return LM(convert(tree))


def numpy_lm_params(cfg: ModelConfig, seed: int,
                    live_seed: Optional[int] = None) -> dict:
    """Seeded numpy weights over the port's ``param_defs``: each leaf drawn
    in turn (sorted key order) from ``np.random.default_rng(seed)`` and
    scaled as ``init_from_defs`` scales; with ``live_seed``, an rwkv
    model's zero-init leaves are then drawn by :func:`set_rwkv_live_leaves`
    from that seed.  The same tree feeds the JAX package (``jnp.asarray``
    per leaf) and, through :func:`lm_params_from_numpy`, the port: this is
    how the golden file ``tests/data/torch_lm_golden.json`` and
    ``chip_smoke.py`` give a card without JAX the weights of a JAX run."""
    rng = np.random.default_rng(seed)

    def leaf(d: ParamDef) -> np.ndarray:
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        return rng.standard_normal(d.shape, dtype=np.float32) * np.float32(d.std())

    tree = map_defs(leaf, param_defs(cfg))
    if live_seed is not None:
        set_rwkv_live_leaves(tree, cfg, live_seed)
    return tree


def set_rwkv_live_leaves(tree, cfg: ModelConfig, seed: int) -> None:
    """Draw, in place, the rwkv leaves that ``init`` leaves at zero, so that
    a random model exercises what they switch on.  Test data, not a
    feature: with ``mu = 0`` the token shifts do nothing, with ``u = 0`` the
    bonus does nothing, and with ``w0 = 0`` the per-step decay is about
    e^-1, so the state carried from one chunk to the next barely reaches
    the output.  Drawn here: ``time_mix.mu`` and ``channel_mix.mu`` in
    (0, 1), ``u`` ~ N(0, 0.5^2), and ``w0`` per channel in (-6, -1) (the
    span of RWKV6's own init: per-step decays from 0.998 down).

    ``tree`` is a parameter tree with numpy or torch leaves (an ``LM``'s
    ``tree()``); the values come from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    L, D = cfg.n_layers, cfg.d_model
    new = {("time_mix", "mu"): rng.uniform(0.0, 1.0, (L, 5, D)),
           ("channel_mix", "mu"): rng.uniform(0.0, 1.0, (L, 2, D)),
           ("time_mix", "u"): rng.normal(0.0, 0.5, (L, D)),
           ("time_mix", "w0"): rng.uniform(-6.0, -1.0, (L, D))}
    for (group, name), a in new.items():
        leaf = tree["blocks"][group][name]
        a = a.astype(np.float32)
        if isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                leaf.copy_(torch.from_numpy(a))
        else:
            tree["blocks"][group][name] = a
