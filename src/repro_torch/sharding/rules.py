"""Logical-axis sharding rules and parameter definition trees.

Counterpart of ``repro.sharding.rules``, onto ``torch.distributed.tensor``
(DTensor) over a ``DeviceMesh`` (``launch.mesh``).  Every parameter and
activation dimension carries a *logical* axis name; a ``ShardingRules``
table maps logical names to the mesh's dim names, so swapping tables
re-lays-out the whole model without touching model code (train: FSDP+TP,
serve: 2D-TP, long-context decode: a sequence-sharded KV cache).

A spec is a tuple with one entry a tensor dim: ``None``, a mesh dim name,
or a tuple of names (the reference's ``PartitionSpec``).  Its DTensor
form (:func:`placements`) is a list with one entry a mesh dim: ``Shard(i)``
where tensor dim ``i`` maps to that mesh dim, else ``Replicate()``.
:func:`constrain` is the counterpart of ``with_sharding_constraint``: a
``redistribute`` (a no-op without a mesh).  Uneven dims are allowed there,
as GSPMD pads them; a parameter's placements come from
:func:`repair_pspec`, which moves an indivisible assignment to another dim.

A model declares its parameters once, as a nested dict of :class:`ParamDef`
leaves (shape, logical axes, initializer, dtype); the same tree yields the
initialized tensors, their meta-device stand-ins, the parameter count and
the placements (:func:`specs_from_defs`, :func:`distribute_tree`).
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import torch

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis name -> mesh dim name (or tuple of names)."""

    rules: Mapping[str, Any]
    name: str = "custom"

    def physical(self, logical: Optional[str], mesh):
        if logical is None:
            return None
        phys = self.rules.get(logical, None)
        if phys is None:
            return None
        names = mesh.mesh_dim_names
        if isinstance(phys, str):
            return phys if phys in names else None
        present = tuple(a for a in phys if a in names)
        return present if present else None

    def pspec(self, axes: Sequence[Optional[str]], mesh) -> tuple:
        return tuple(self.physical(a, mesh) for a in axes)


# Training: FSDP over "data" (+ pure DP over "pod"), TP over "model".
TRAIN_RULES = ShardingRules(
    name="train_fsdp_tp",
    rules={
        "batch": ("pod", "data"),
        "cache_batch": ("pod", "data"),
        "act_batch": ("pod", "data"),
        "act_seq": "model",       # scan-carry activations: sequence-sharded (SP)
        "act_embed": None,
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "vocab": "model",
        "embed_fsdp": "data",     # parameter dim sharded ZeRO-3 style
        "experts": None,          # baseline: TP-within-expert
        "moe_wD": None,           # expert weights gathered over data at use
        "cache_seq": None,
        "state": None,
    },
)

# Prefill: no backward pass, so the carry keeps the sequence unsharded.
PREFILL_RULES = ShardingRules(
    name="prefill_seq_unsharded",
    rules={**TRAIN_RULES.rules, "act_seq": None},
)

# Training without FSDP: weights replicated over "data".
TRAIN_TP_REPLICATED = ShardingRules(
    name="train_tp_replicated",
    rules={**TRAIN_RULES.rules, "embed_fsdp": None},
)

# Serving (decode): weights stationary, 2-D sharded (model x data); the
# residual stream D-sharded over "data"; the KV cache (batch x kv-heads).
SERVE_RULES = ShardingRules(
    name="serve_2d_stationary",
    rules={
        "batch": ("pod", "data"),
        "cache_batch": ("pod", "data"),
        "act_batch": None,
        "act_seq": None,
        "act_embed": "data",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "vocab": "model",
        "embed_fsdp": "data",
        "experts": None,
        "moe_wD": "data",
        "cache_seq": None,
        "state": None,
    },
)

# Long-context decode (batch=1): KV cache sequence-sharded over "data".
LONG_DECODE_RULES = ShardingRules(
    name="long_decode_seqshard",
    rules={
        "batch": None,
        "cache_batch": None,
        "act_batch": None,
        "act_seq": None,
        "act_embed": "data",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "vocab": "model",
        "embed_fsdp": "data",
        "experts": None,
        "moe_wD": "data",
        "cache_seq": "data",
        "state": "data",
    },
)

RULE_SETS = {r.name: r for r in (TRAIN_RULES, TRAIN_TP_REPLICATED,
                                 PREFILL_RULES, SERVE_RULES,
                                 LONG_DECODE_RULES)}


def logical_to_pspec(axes: Sequence[Optional[str]], rules: ShardingRules,
                     mesh) -> tuple:
    return rules.pspec(axes, mesh)


def placements(spec: Sequence, mesh) -> list:
    """A spec's DTensor placements on ``mesh``: for each mesh dim,
    ``Shard(i)`` where tensor dim ``i``'s entry names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    for i, p in enumerate(spec):
        for name in (() if p is None else (p,) if isinstance(p, str) else p):
            d = mesh.mesh_dim_names.index(name)
            # a dim of one rank holds the whole tensor either way; kept
            # replicated, no view rule meets a shard there
            if mesh.size(d) > 1:
                out[d] = Shard(i)
    return out


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]],
              rules: ShardingRules, mesh) -> torch.Tensor:
    """``x`` redistributed to its logical axes' placements (no-op without
    a mesh): ``with_sharding_constraint``.  A plain tensor under a mesh
    holds the same values on every rank and joins it as ``Replicate``."""
    if mesh is None:
        return x
    return as_dtensor(x, mesh).redistribute(
        mesh, placements(rules.pspec(axes, mesh), mesh))


def gather_inner(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every dim but its first and last whole on each rank: a
    DTensor's shards of those dims gathered (the sequence of a
    sequence-parallel activation), a plain tensor as it is.  A matrix
    product flattens ``[B, S, ...]`` into rows, which DTensor's view rule
    refuses with ``S`` sharded; the layers gather it where activations
    enter their products, as GSPMD does for ``act_seq``."""
    mesh = mesh_of(x)
    if mesh is None or not any(p.is_shard() and 0 < p.dim < x.ndim - 1
                               for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(mesh, [
        Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1 else p
        for p in x.placements])


def as_dtensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as a DTensor of ``mesh``: a DTensor as it is, a plain tensor
    (the same values on every rank) replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def mesh_of(x: torch.Tensor):
    """The mesh of a DTensor, ``None`` for a plain tensor.  No DTensor
    exists before ``torch.distributed.tensor`` is imported, so a process
    that never shards does not pay for importing it."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(x, dtensor.DTensor):
        return None
    return x.device_mesh


def like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A constant ``t`` built beside activation ``x``: replicated on
    ``x``'s mesh when ``x`` is a DTensor, else ``t``."""
    mesh = mesh_of(x)
    return t if mesh is None else as_dtensor(t, mesh)


def head_layout(x: torch.Tensor, heads: Sequence[int]) -> list:
    """The per-rank layout of a ``[B, S, H, ...]`` DTensor that attention
    or a recurrence can run on locally: for each mesh dim, ``"batch"``
    where it shards dim 0, ``"heads"`` where it shards dim 2 and divides
    every head count in ``heads`` (contiguous blocks of query heads then
    meet their own KV heads), else ``None`` (the dim gathered)."""
    mesh = x.device_mesh
    return ["batch" if p.is_shard(0) else
            "heads" if p.is_shard(2) and all(
                h % mesh.size(d) == 0 for h in heads) else None
            for d, p in enumerate(x.placements)]


def layout_placements(layout: Sequence, batch_dim: Optional[int],
                      head_dim: Optional[int]) -> list:
    """A :func:`head_layout`'s placements for a tensor whose batch and
    head dims are ``batch_dim`` and ``head_dim`` (``None``: it has none,
    and is replicated over that mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for kind in layout:
        dim = {"batch": batch_dim, "heads": head_dim}.get(kind)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def to_local_as(x: torch.Tensor, mesh, place: Sequence,
                split: Sequence[bool]) -> torch.Tensor:
    """This rank's shard of ``x`` redistributed to ``place``, for a local
    computation that each mesh dim marked in ``split`` divides among its
    ranks (their rows or heads).  Gradients flow back as DTensors of
    ``place``, but partial sums on a split dim that ``x`` is replicated
    over: each rank's gradient there covers its own rows or heads only."""
    from torch.distributed.tensor import Partial
    grad = [Partial() if s and p.is_replicate() else p
            for p, s in zip(place, split)]
    return as_dtensor(x, mesh).redistribute(mesh, list(place)).to_local(
        grad_placements=grad)


def from_local_as(x: torch.Tensor, mesh, place: Sequence,
                  shape: Sequence[int]) -> torch.Tensor:
    """Each rank's shard ``x`` as one DTensor of global ``shape``."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(x.contiguous(), mesh, list(place),
                              run_check=False, shape=shape, stride=stride)


def on_local_heads(fn, args: Sequence[torch.Tensor], dims: Sequence,
                   outs: Sequence, heads: Sequence[int]):
    """``fn(*args)`` on each rank's batch rows and whole heads when
    ``args[0]`` is a DTensor, else as it is: attention, the WKV and the
    SSD scan run on local shards, so no kernel receives a DTensor.
    ``dims`` holds each argument's ``(batch dim, head dim)`` and ``outs``
    each output's ``((batch dim, head dim), global shape)``, ``None`` for
    a dim a tensor lacks (it is whole on the ranks of that mesh dim).  The
    layout is ``args[0]``'s :func:`head_layout` over the head counts
    ``heads``.  With one entry in ``outs``, ``fn`` returns one tensor and
    so does this.  Gradients flow through both conversions."""
    mesh = mesh_of(args[0])
    if mesh is None:
        return fn(*args)
    layout = head_layout(args[0], heads)
    split = [bool(kind) for kind in layout]
    res = fn(*(to_local_as(t, mesh, layout_placements(layout, *d),
                           split).contiguous() for t, d in zip(args, dims)))
    res = (res,) if len(outs) == 1 else res
    out = tuple(from_local_as(y, mesh, layout_placements(layout, *d), shape)
                for y, (d, shape) in zip(res, outs))
    return out[0] if len(outs) == 1 else out


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor, or a plain tensor itself."""
    mesh = mesh_of(x)
    return x if mesh is None else x.to_local()


def replicas(x: torch.Tensor) -> int:
    """How many ranks of its mesh hold each element of DTensor ``x`` (the
    product of the mesh dims it is replicated over); 1 for a plain
    tensor."""
    mesh = mesh_of(x)
    if mesh is None:
        return 1
    return math.prod(mesh.size(d) for d, p in enumerate(x.placements)
                     if p.is_replicate())


def all_reduce_mesh(t: torch.Tensor, mesh, op=None) -> torch.Tensor:
    """All-reduce plain tensor ``t`` in place over every rank of ``mesh``
    (one collective a mesh dim of size > 1; sum by default)."""
    import torch.distributed as dist
    op = dist.ReduceOp.SUM if op is None else op
    for d in range(mesh.ndim):
        if mesh.size(d) > 1:
            dist.all_reduce(t, op=op, group=mesh.get_group(d))
    return t


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes + initializer."""

    shape: Tuple[int, ...]
    axes: Axes
    init: str = "normal"      # normal | zeros | ones | embed
    scale: Optional[float] = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")

    def std(self) -> float:
        """The normal initializer's standard deviation: fan-in scaling on
        the contracting dim, 1.0 for embeddings, unless ``scale`` is set."""
        if self.scale is not None:
            return self.scale
        if self.init == "embed":
            return 1.0
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return fan_in ** -0.5


def map_defs(fn: Callable[[ParamDef], Any], defs):
    """Apply ``fn`` to every ``ParamDef`` of a nested dict, in sorted key
    order (the order JAX flattens a dict in), keeping the tree's shape."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, defs[k]) for k in sorted(defs)}


def leaves(defs) -> list:
    out = []
    map_defs(out.append, defs)
    return out


def _leaf_init(d: ParamDef, generator: torch.Generator) -> torch.Tensor:
    device = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init in ("normal", "embed"):
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        # scaled in place: a stacked expert leaf is tens of GB at full width
        return x.mul_(d.std()).to(d.dtype)
    raise ValueError(f"unknown init {d.init!r}")


def init_from_defs(defs, generator: torch.Generator):
    """Initialize a tree of ParamDefs on ``generator``'s device, drawing
    the leaves one after another from ``generator``.  The scaling is the
    JAX package's; the numbers are torch's own."""
    return map_defs(lambda d: _leaf_init(d, generator), defs)


def shapes_from_defs(defs):
    """Meta-device tensors of each leaf's shape and dtype: no allocation."""
    return map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for d in leaves(defs))


def _axis_size(mesh, phys) -> int:
    names = (phys,) if isinstance(phys, str) else tuple(phys)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in names)


def repair_pspec(shape: Tuple[int, ...], spec: Sequence, mesh) -> tuple:
    """Divisibility-aware spec repair for a parameter's placements.

    A dim not divisible by its assigned mesh dims (e.g. 8 KV heads over a
    16-way model axis) loses the assignment, which is re-placed on the
    right-most free dim that is divisible (typically head_dim): the tensor
    stays fully distributed, just along a different dim."""
    phys = list(spec) + [None] * (len(shape) - len(spec))
    out, dropped = [], []
    for dim, p in zip(shape, phys):
        if p is None:
            out.append(None)
        elif dim % _axis_size(mesh, p) == 0:
            out.append(p)
        else:
            out.append(None)
            dropped.append(p)
    for p in dropped:
        for i in range(len(out) - 1, -1, -1):
            if out[i] is None and shape[i] % _axis_size(mesh, p) == 0:
                out[i] = p
                break
    return tuple(out)


def param_spec(d: ParamDef, rules: ShardingRules, mesh) -> tuple:
    """A parameter's repaired spec."""
    return repair_pspec(d.shape, rules.pspec(d.axes, mesh), mesh)


def specs_from_defs(defs, rules: ShardingRules, mesh):
    """The tree of DTensor placement lists matching the def tree, built
    from each leaf's repaired spec."""
    return map_defs(lambda d: placements(param_spec(d, rules, mesh), mesh),
                    defs)


def distribute(x: torch.Tensor, mesh, place: Sequence) -> torch.Tensor:
    """``x`` (the same full tensor on every rank) as a DTensor of ``mesh``
    with ``place``: each rank keeps its own slice, with no communication
    (``distribute_tensor``'s split, uneven dims included).  A slice is
    copied, so the shard does not hold ``x``'s whole storage."""
    from torch.distributed.tensor import DTensor
    shard = local_slice(x, mesh, place)
    if shard.numel() < x.numel():
        shard = shard.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(shard.contiguous(), mesh, list(place),
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def local_slice(x: torch.Tensor, mesh, place: Sequence) -> torch.Tensor:
    """This rank's slice (a view) of full tensor ``x`` under ``place``."""
    coord = mesh.get_coordinate()
    for md, p in enumerate(place):
        if p.is_shard():
            x = torch.tensor_split(
                x, _chunk_bounds(x.shape[p.dim], mesh.size(md)),
                dim=p.dim)[coord[md]]
    return x


def _chunk_bounds(n: int, parts: int) -> list:
    """``torch.chunk``'s split points of ``n`` into ``parts`` (DTensor's
    split of an uneven dim: ceil-sized chunks, the last ones short or
    empty)."""
    size = -(-n // parts)
    return [min(size * i, n) for i in range(1, parts)]


def distribute_tree(tree, specs, mesh):
    """A tree of full tensors distributed by a matching tree of placement
    lists (:func:`specs_from_defs`)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], specs[k], mesh) for k in tree}
    return distribute(tree, mesh, specs)
