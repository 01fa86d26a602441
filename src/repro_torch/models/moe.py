"""Mixture-of-Experts layer: top-k routing and capacity-bounded dispatch.

Counterpart of ``repro.models.moe``.  Tokens are routed within their own
batch row, in groups of at most ``GROUP_MAX`` tokens (the group count
doubles while it divides the sequence and a group is longer than that).
Each (row, group) gives every expert ``C = ceil(S_g k cf / E)`` slots; a
routed slot's position is its rank among the slots sent to its expert, in
flattened ``(token, k)`` order within the group, and slots at or past C
are dropped (Switch / GShard semantics).

The JAX package dispatches with one-hot matrix products over a
``[T, E*C]`` tensor.  Each of its rows holds at most one 1, so a gather of
the tokens into an ``[E*C, D]`` buffer by slot, and a gather back with a
zero row standing for every dropped slot, compute the same values bit for
bit without that tensor.  The expert products are one batched matrix
product each over every (row, group) at once.

:func:`recording` collects each call's routing (the experts picked, which
slots were kept, the top-k margin) for the checks that compare two paths;
:func:`forcing` runs a path on another's recorded experts, so that two
paths' outputs are held to one continuous tolerance.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp, mlp_defs
from repro_torch.sharding.rules import (
    ParamDef, constrain, from_local_as, mesh_of, to_local_as,
)

GROUP_MAX = 1024          # the longest dispatch group before it is halved

_RECORD: Optional[list] = None
_FORCE: Optional[list] = None


def moe_defs(cfg: ModelConfig, layers: tuple[int, ...] = ()):
    D, F_, E = cfg.d_model, cfg.expert_ff, cfg.n_experts
    lx = ("layers",) * len(layers)
    d = {
        "router": ParamDef(layers + (D, E), lx + ("embed_fsdp", None)),
        "wi": ParamDef(layers + (E, D, F_), lx + ("experts", "embed_fsdp", "mlp")),
        "wg": ParamDef(layers + (E, D, F_), lx + ("experts", "embed_fsdp", "mlp")),
        "wo": ParamDef(layers + (E, F_, D), lx + ("experts", "mlp", "embed_fsdp")),
    }
    if cfg.n_shared_experts:
        d["shared"] = mlp_defs(cfg, layers,
                               d_ff=cfg.expert_ff * cfg.n_shared_experts)
    return d


def _capacity(S: int, cfg: ModelConfig) -> int:
    return max(int(math.ceil(S * cfg.top_k * cfg.capacity_factor
                             / cfg.n_experts)), 1)


def n_groups(S: int) -> int:
    """Dispatch groups a row of ``S`` tokens is split into."""
    nG = 1
    while S % (nG * 2) == 0 and S // nG > GROUP_MAX:
        nG *= 2
    return nG


@contextlib.contextmanager
def recording():
    """Collect the routing of every :func:`apply_moe` call inside the
    block, in call order: a list of dicts with ``gate_idx`` ``[B, S, k]``,
    ``kept`` ``[B, S, k]`` (the slot was not dropped) and ``margin``
    ``[B, S]`` (the k-th largest router probability less the (k+1)-th;
    ``inf`` when every expert is picked)."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = outer


@contextlib.contextmanager
def forcing(gate_idx: list):
    """Route the :func:`apply_moe` calls inside the block, in call order, to
    the experts of ``gate_idx`` (``[B, S, k]`` tensors, as
    :func:`recording` gives them), each call's gates read off its own
    router probabilities at those experts."""
    global _FORCE
    outer, _FORCE = _FORCE, list(gate_idx)
    try:
        yield
    finally:
        _FORCE = outer


def route(p, x: torch.Tensor, cfg: ModelConfig,
          gate_idx: Optional[torch.Tensor] = None):
    """Router probabilities and top-k: ``(probs [B, S, E] f32, gate_val
    [B, S, k] f32, renormalised, gate_idx [B, S, k], margin [B, S])``.

    The logits are computed in the activations' dtype and taken to f32 for
    the softmax.  A stable descending sort breaks ties as ``lax.top_k``
    does: among equal probabilities the lower index comes first.  A given
    ``gate_idx`` takes the top-k's place."""
    K = cfg.top_k
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    if gate_idx is None:
        gate_idx = order.indices[..., :K]
    gate_val = probs.gather(-1, gate_idx)
    gate_val = gate_val / torch.clamp(gate_val.sum(-1, keepdim=True), min=1e-9)
    if K < cfg.n_experts:
        margin = (order.values[..., K - 1] - order.values[..., K]).detach()
    else:
        margin = torch.full(probs.shape[:-1], math.inf, device=x.device)
    return probs, gate_val, gate_idx, margin


def dispatch_slots(gate_idx: torch.Tensor, nG: int, C: int, E: int):
    """Each routed slot's place in its (row, group)'s expert buffer:
    ``(slot [R, T], kept [R, T])`` over the ``R = B nG`` groups of ``T = S_g
    k`` slots, where ``slot`` is ``e C + position`` for a kept slot and ``E
    C`` (the drop row) for a dropped one."""
    B, S, K = gate_idx.shape
    ef = gate_idx.reshape(B * nG, (S // nG) * K)
    # rank of each slot among the group's earlier slots to the same expert
    pos = (F.one_hot(ef, E).cumsum(1) - 1).gather(2, ef[..., None])[..., 0]
    kept = pos < C
    return torch.where(kept, ef * C + pos, E * C), kept


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, rules=None, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux_loss f32 scalar).

    Under a mesh (DTensor ``x``) the expert weights are laid out by
    ``rules`` (``moe_wD``: gathered over data under the training rules),
    then the routing, the capacity-bounded dispatch and the expert products
    run on each rank's batch rows with the weights gathered whole (a row's
    groups never cross ranks, so each row keeps the ``mesh=None``
    grouping and drops); the balance loss averages over every row."""
    E = cfg.n_experts
    if mesh_of(x) is None:
        y, probs, top1 = _dispatch(p, x, cfg)
    else:
        y, probs, top1 = _dispatch_rows(p, x, cfg, rules, mesh)
    # Switch-style aux loss: E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    ce = top1.mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    if cfg.n_shared_experts:
        y = y + apply_mlp(p["shared"], x, cfg)
    return y, aux


def _dispatch_rows(p, x, cfg, rules, mesh):
    """:func:`_dispatch` on each rank's batch rows (the mesh dims that
    shard ``x``'s dim 0; every other dim gathered), the weights whole."""
    from torch.distributed.tensor import Replicate, Shard
    dt = x.dtype
    weights = {"router": p["router"]}
    for n, axes in (("wi", ("experts", "moe_wD", "mlp")),
                    ("wg", ("experts", "moe_wD", "mlp")),
                    ("wo", ("experts", "mlp", "moe_wD"))):
        weights[n] = constrain(p[n].to(dt), axes, rules, mesh)
    whole = [Replicate()] * mesh.ndim
    rows = [Shard(0) if q.is_shard(0) else Replicate() for q in x.placements]
    split = [q.is_shard() for q in rows]
    y, probs, top1 = _dispatch(
        {n: to_local_as(w, mesh, whole, split) for n, w in weights.items()},
        to_local_as(x, mesh, rows, split), cfg)
    B, S, _ = x.shape
    E = cfg.n_experts
    y = from_local_as(y, mesh, rows, x.shape)
    y = constrain(y, ("act_batch", "act_seq", "act_embed"), rules, mesh)
    return (y, from_local_as(probs, mesh, rows, (B, S, E)),
            from_local_as(top1, mesh, rows, (B, S, E)))


def _dispatch(p, x: torch.Tensor, cfg: ModelConfig):
    """The routed experts' output ``y`` [B, S, D] (no shared expert), the
    router probabilities [B, S, E] and each token's top-1 expert one-hot
    (f32), the two terms of the balance loss."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = x.dtype
    probs, gate_val, gate_idx, margin = route(
        p, x, cfg, None if _FORCE is None else _FORCE.pop(0))
    top1 = F.one_hot(gate_idx[..., 0], E).float()

    nG = n_groups(S)
    S_g = S // nG
    C = _capacity(S_g, cfg)
    R, T = B * nG, S_g * K
    slot, kept = dispatch_slots(gate_idx, nG, C, E)
    if _RECORD is not None:
        _RECORD.append({"gate_idx": gate_idx.detach(),
                        "kept": kept.reshape(B, S, K), "margin": margin})

    # the token each expert slot holds; an empty slot holds the zero row
    # S_g (the drop row E*C collects the dropped slots and is cut off)
    src = torch.full((R, E * C + 1), S_g, dtype=torch.long, device=x.device)
    src.scatter_(1, slot, (torch.arange(T, device=x.device) // K).expand(R, T))
    xg = F.pad(x.reshape(R, S_g, D), (0, 0, 0, 1))
    buf = torch.gather(xg, 1, src[:, :E * C, None].expand(R, E * C, D))
    buf = buf.reshape(R, E, C, D).transpose(0, 1).reshape(E, R * C, D)
    h = buf @ p["wi"].to(dt)
    g = buf @ p["wg"].to(dt)
    yy = (F.silu(g) * h) @ p["wo"].to(dt)                 # [E, R C, D]
    yy = yy.reshape(E, R, C, D).transpose(0, 1).reshape(R, E * C, D)
    yy = F.pad(yy, (0, 0, 0, 1))                          # a dropped slot reads 0
    picked = torch.gather(yy, 1, slot[..., None].expand(R, T, D))
    picked = picked * gate_val.reshape(R, T, 1).to(dt)
    y = picked.reshape(R, S_g, K, D).sum(dim=2).reshape(B, S, D)
    return y, probs, top1
