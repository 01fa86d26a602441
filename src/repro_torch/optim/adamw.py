"""AdamW (decoupled weight decay) and its cosine schedule, on trees of
tensors.

Counterpart of ``repro.optim.adamw``: the same formulas in the same order,
in f32.  The schedule, the bias corrections and the clip scale are 0-d f32
tensors on the parameters' device, as the reference's traced scalars are,
and every division by a config constant divides by such a tensor (a CUDA
division by a Python scalar multiplies by its reciprocal, which rounds
otherwise).

``adamw_update`` updates the parameters and both moments **in place**, one
leaf at a time and a slice of at most ``SLICE`` elements at a time: at
full width (llama3.2-3b: 12.85 GB of f32 master weights, 51.4 GB with the
gradients and both moments) a functional update of the whole tree, or one
``_foreach`` call over every leaf, would need the state twice over.

Under a mesh the leaves are DTensors of one layout per parameter (the
gradients redistributed to their parameter's placements first): the
update runs elementwise on each rank's local shards, and the gradient norm
sums each rank's local squares, each element counted once (a leaf
replicated over ``n`` ranks adds ``1/n`` of its squares on each), then
all-reduces the sum over the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.sharding.rules import (
    all_reduce_mesh, local, mesh_of, replicas,
)
from repro_torch.tree import tree_leaves, tree_map

SLICE = 1 << 24          # elements an update step touches at once (64 MB f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


@dataclasses.dataclass
class OptState:
    """First and second moments (trees shaped like the parameters, f32)
    and the step count (0-d int32)."""
    m: Any
    v: Any
    step: torch.Tensor


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _slices(x: torch.Tensor):
    """Flat views of ``x`` of at most SLICE elements each."""
    flat = x.view(-1)
    return [flat[i:i + SLICE] for i in range(0, flat.numel(), SLICE)]


def adamw_init(params) -> OptState:
    leaf = tree_leaves(params)[0]
    return OptState(m=tree_map(torch.zeros_like, params),
                    v=tree_map(torch.zeros_like, params),
                    step=torch.zeros((), dtype=torch.int32, device=leaf.device))


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to ``min_lr_frac`` of
    it at ``total_steps``; f32 of the (0-d) step count."""
    step = step.float()
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm of every leaf together, summed leaf by leaf in the
    reference's order (under a mesh each rank's share, then all-reduced)."""
    total, mesh = 0, None
    for x in tree_leaves(tree):
        mesh, n = mesh or mesh_of(x), replicas(x)
        for s in _slices(local(x)):
            sq = torch.sum(torch.square(s.float()))
            total = total + (sq if n == 1 else sq / n)
    if mesh is not None:
        total = all_reduce_mesh(total, mesh)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    grads, state: OptState, params, cfg: AdamWConfig,
) -> Tuple[Any, OptState, dict]:
    """One AdamW step with global-norm clipping.  Updates ``params`` and
    ``state``'s moments in place and returns ``(params, OptState with the
    new step, {"grad_norm", "lr"})``."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.grad_clip, gnorm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(*(tree_leaves(t) for t in (params, grads, state.m,
                                                       state.v))):
        for ps, gs, ms, vs in zip(*(_slices(local(t)) for t in (p, g, m, v))):
            gf = gs.float() * scale
            ms.copy_(b1 * ms + (1 - b1) * gf)
            vs.copy_(b2 * vs + (1 - b2) * gf * gf)
            delta = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps) \
                + cfg.weight_decay * ps
            ps.copy_(ps - lr * delta)
    return params, OptState(m=state.m, v=state.v, step=step), {
        "grad_norm": gnorm, "lr": lr}
