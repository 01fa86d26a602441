"""Carry job tables, simulation state and model weights between numpy and
the port.

The tests hand the identical job table and mid-run state to both engines:
``{name: np.ndarray}`` dicts read off the reference's ``JobSet`` /
``SimState`` go in through :func:`jobset_from_numpy` and
:func:`simstate_from_numpy`, and :func:`to_numpy` turns the port's objects
back into such dicts.  LM weights cross as numpy trees:
:func:`lm_params_from_numpy` takes the JAX package's parameters (or the
seeded ones of :func:`numpy_lm_params`) into the port's ``LM``, and
:func:`set_live_leaves` draws the leaves that the initializer leaves at
zero or one (rwkv's, the Mamba2 layers', the QK norms, an
encoder-decoder's LayerNorms).
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
from repro_torch.models.api import get_model
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import OptState
from repro_torch.optim.compression import CompressionState
from repro_torch.sharding.rules import ParamDef, map_defs
from repro_torch.tree import tree_map


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
                    live_seed: Optional[int] = None,
                    fan_in: bool = False) -> dict:
    """Seeded numpy weights over the port's ``param_defs`` (any family,
    the encoder-decoder's too): each leaf drawn
    in turn (sorted key order) from ``np.random.default_rng(seed)`` and
    scaled as ``init_from_defs`` scales; with ``live_seed``, the leaves
    that the initializer leaves at zero or one are then drawn by
    :func:`set_live_leaves` from that seed; with ``fan_in``, the attention
    projections are then scaled to their true fan-in
    (:func:`scale_attention_fan_in`).
    The same tree feeds the JAX package (``jnp.asarray``
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

    tree = map_defs(leaf, get_model(cfg).param_defs)
    if live_seed is not None:
        set_live_leaves(tree, cfg, live_seed)
    if fan_in:
        scale_attention_fan_in(tree, cfg)
    return tree


def scale_attention_fan_in(tree: dict, cfg: ModelConfig) -> None:
    """Scale, in place, a numpy tree's attention projections (every
    subtree of :func:`attention_trees`) from the
    reference initializer's fan-in (the heads axis) to their true one:
    std ``d_model^-0.5`` for ``wq``/``wk``/``wv``, ``(H hd)^-0.5`` for
    ``wo``.  Drawn the reference's way, q and k reach ~20 and a random
    model is chaotic: two f32 implementations drift apart through its
    layers (and its training steps) by more than their rounding.  Test data,
    as ``chip_smoke.py``'s ``fan_in_attention`` is for a torch tree."""
    for a in attention_trees(tree):
        for n in ("wq", "wk", "wv"):                      # [(L,) D, heads, hd]
            a[n] = a[n] * np.float32((a[n].shape[-2] / cfg.d_model) ** 0.5)
        a["wo"] = a["wo"] * np.float32(a["wo"].shape[-3] ** -0.5)


def attention_trees(tree: dict) -> list:
    """The attention projections' subtrees of an LM tree: the stacked
    blocks', a hybrid model's shared block's, or an encoder-decoder's
    three (the encoder's, the decoder's self- and cross-attention)."""
    if "decoder" in tree:
        return [tree["encoder"]["attn"], tree["decoder"]["self_attn"],
                tree["decoder"]["cross_attn"]]
    return [(tree["shared_attn"] if "shared_attn" in tree
             else tree["blocks"])["attn"]]


def _from_numpy(tree, device):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def opt_state_from_numpy(m, v, step, device) -> OptState:
    """The port's ``OptState`` from numpy trees of the moments (the
    reference's ``OptState.m``/``.v``) and its step count."""
    return OptState(m=_from_numpy(m, device), v=_from_numpy(v, device),
                    step=torch.tensor(int(step), dtype=torch.int32,
                                      device=device))


def compression_state_from_numpy(residual, device) -> CompressionState:
    """The port's ``CompressionState`` from a numpy tree (or 0-d array) of
    the reference's residuals."""
    return CompressionState(residual=_from_numpy(residual, device))


def state_to_numpy(tree):
    """A tree of the port's tensors (an ``LM``, an ``OptState``, a
    ``CompressionState``, a gradient tree) as the same tree of numpy
    arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _set_leaves(group: dict, values: dict) -> None:
    """Write ``values`` (``{name: array}``) into ``group``, a subtree of a
    tree with numpy or torch leaves: in place for a tensor, as a new f32
    leaf for an array."""
    for name, a in values.items():
        a = np.asarray(a, dtype=np.float32)
        if isinstance(group[name], torch.Tensor):
            with torch.no_grad():
                group[name].copy_(torch.from_numpy(a))
        else:
            group[name] = a


def set_live_leaves(tree, cfg: ModelConfig, seed: int) -> None:
    """Draw, in place, the leaves that ``init`` leaves at zero or one, by
    family: rwkv's (:func:`set_rwkv_live_leaves`), the Mamba2 layers'
    (:func:`set_ssm_live_leaves`), an encoder-decoder's LayerNorms
    (:func:`set_norm_live_leaves`), and the QK norms where the config has
    them (:func:`set_qk_norm_live_leaves`)."""
    if cfg.family == "rwkv":
        set_rwkv_live_leaves(tree, cfg, seed)
    if cfg.family == "hybrid":
        set_ssm_live_leaves(tree, cfg, seed)
    if cfg.family == "encdec":
        set_norm_live_leaves(tree, cfg, seed)
    if cfg.qk_norm:
        set_qk_norm_live_leaves(tree, cfg, seed)


def set_ssm_live_leaves(tree, cfg: ModelConfig, seed: int) -> None:
    """Draw, in place, the Mamba2 leaves that ``init`` leaves at zero or
    one, so that a random hybrid model exercises what they switch on.
    Test data, not a feature: with ``A_log = dt_bias = 0`` every step
    decays the state by about a half, so little of it crosses a chunk, and
    ``conv_b``, ``D_skip`` and ``norm_scale`` at 0 or 1 hide a mix-up of
    those leaves.  Drawn here, from Mamba2's own init ranges: ``A_log``
    in (0, log 16) (A from -1 to -16), ``dt_bias`` the inverse softplus of
    a dt log-uniform in (1e-3, 0.1), ``conv_b`` ~ N(0, 0.1^2), ``D_skip``
    and ``norm_scale`` in (0.5, 1.5).

    ``tree`` is a parameter tree with numpy or torch leaves (an ``LM``'s
    ``tree()``); the values come from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    lead = (cfg.n_layers // cfg.attn_every, cfg.attn_every)
    H, Cd = cfg.ssm_heads, cfg.d_inner + 2 * cfg.ssm_state
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), lead + (H,)))
    _set_leaves(tree["mamba"], {
        "A_log": rng.uniform(0.0, np.log(16.0), lead + (H,)),
        "dt_bias": dt + np.log(-np.expm1(-dt)),
        "conv_b": rng.normal(0.0, 0.1, lead + (Cd,)),
        "D_skip": rng.uniform(0.5, 1.5, lead + (H,)),
        "norm_scale": rng.uniform(0.5, 1.5, lead + (cfg.d_inner,))})


def _norms(tree: dict) -> list:
    """Every norm subtree of a tree (a dict holding a ``scale``), in sorted
    path order."""
    if "scale" in tree:
        return [tree]
    return [x for k in sorted(tree) if isinstance(tree[k], dict)
            for x in _norms(tree[k])]


def set_norm_live_leaves(tree, cfg: ModelConfig, seed: int) -> None:
    """Draw, in place, every norm's ``scale`` (ones from ``init``) in (0.5,
    1.5) and, for a LayerNorm, its ``bias`` (zeros) from N(0, 0.1^2), in
    sorted path order, so that a check sees a norm applied in the wrong
    place or swapped with another.  Test data; the values come from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    for norm in _norms(tree):
        new = {"scale": rng.uniform(0.5, 1.5, tuple(norm["scale"].shape))}
        if "bias" in norm:
            new["bias"] = rng.normal(0.0, 0.1, tuple(norm["bias"].shape))
        _set_leaves(norm, new)


def set_qk_norm_live_leaves(tree, cfg: ModelConfig, seed: int) -> None:
    """Draw, in place, the QK-norm scales (``q_norm``, ``k_norm``: ones
    from ``init``) in (0.5, 1.5), so that a check sees a swap of the two
    or of their head-dim entries.  Test data; the values come from
    ``np.random.default_rng(seed)``, after any other live leaves of the
    family are drawn from their own generator."""
    rng = np.random.default_rng(seed)
    a, = attention_trees(tree)
    _set_leaves(a, {n: rng.uniform(0.5, 1.5, tuple(a[n].shape))
                    for n in ("q_norm", "k_norm")})


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
        _set_leaves(tree["blocks"][group], {name: a})
