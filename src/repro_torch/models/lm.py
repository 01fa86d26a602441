"""Decoder-only LM, dense, moe, hybrid, rwkv and vlm families: parameters,
full forward, prefill, decode.

Counterpart of ``repro.models.lm`` (the encoder-decoder family is
``models.encdec``).  One declarative ``param_defs`` tree with stacked
``[L, ...]`` layer leaves, the JAX package's names and shapes, held in an
:class:`LM` module; the building blocks are plain functions on its tree:

    loss_fn(params, batch, cfg)                -> (loss, {"ce", "aux"})
    forward(params, batch, cfg)                -> (logits, cache or None)
    prefill(params, batch, cfg)                -> (last_logits, cache)
    decode_step(params, tokens, pos, cache, cfg) -> (logits, cache)

A Python loop over the layers takes the place of ``lax.scan``.  The
projections and the unembedding are plain matrix products; attention over
the whole sequence goes through ``attention.attend``, which runs the CUDA
kernel when ``cfg.use_pallas`` is set, and the rwkv time-mix over the whole
sequence through ``rwkv.apply_time_mix``, which runs the ``linattn_scan``
CUDA kernel when it is set.  A moe layer's feed-forward is
``moe.apply_moe`` (top-k routing, capacity-bounded dispatch; its balance
loss is the layer's aux).  A hybrid (zamba2) model is groups of
``attn_every`` Mamba2 layers (``ssm.apply_ssm``), each group followed by
one shared attention block, the same weights every time.  A vlm model is
the dense stack over the projected patch embeddings (``frontend_proj``)
followed by the text's token embeddings; the logits and the loss cover the
text positions only.

``loss_fn`` is the training path: it is differentiable through the plain
blockwise attention and ``wkv_chunked`` (the kernels have no backward
pass), with each layer checkpointed under ``cfg.remat``
(:func:`_maybe_remat`).  ``prefill`` and ``decode_step`` serve and record
no gradients.  A stacked layer leaf of the tree a loss is taken of may also
be a sequence of per-layer tensors (the trainer's view, whose gradients
land in per-layer slices instead of a full ``[L, ...]`` tensor a layer).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp, apply_norm, apply_rope, checkpointed, chunked_lm_loss,
    compute_dtype, embed_defs, embed_tokens, logits_from_hidden, mlp_defs,
    mm, norm_defs, rms_norm_simple,
)
from repro_torch.sharding.rules import (
    TRAIN_RULES, ParamDef, ShardingRules, constrain, from_local_as, like,
    local, mesh_of,
)

Tree = Dict[str, Any]


FAMILIES = ("dense", "moe", "hybrid", "rwkv", "vlm")


def _require_family(cfg: ModelConfig) -> None:
    """This module's families; the others (encdec: ``models.encdec``)
    raise, as the reference's ``param_defs`` does."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"lm.py does not handle family {cfg.family!r}")


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _block_defs(cfg: ModelConfig, layers: tuple[int, ...]):
    d = {
        "ln1": norm_defs(cfg, layers),
        "attn": attn.attn_defs(cfg, layers),
        "ln2": norm_defs(cfg, layers),
    }
    if cfg.n_experts:
        d["moe"] = moe_mod.moe_defs(cfg, layers)
    else:
        d["mlp"] = mlp_defs(cfg, layers)
    return d


def _groups(cfg: ModelConfig) -> int:
    """A hybrid model's groups of ``attn_every`` Mamba2 layers."""
    return cfg.n_layers // cfg.attn_every


def param_defs(cfg: ModelConfig) -> Tree:
    _require_family(cfg)
    L = (cfg.n_layers,)
    defs = {"embed": embed_defs(cfg), "final_norm": norm_defs(cfg)}
    if cfg.family == "hybrid":
        defs["mamba"] = ssm_mod.ssm_defs(cfg, (_groups(cfg), cfg.attn_every))
        defs["shared_attn"] = {"ln1": norm_defs(cfg),
                               "attn": attn.attn_defs(cfg),
                               "ln2": norm_defs(cfg), "mlp": mlp_defs(cfg)}
    elif cfg.family == "rwkv":
        defs["blocks"] = {"ln1": norm_defs(cfg, L), "ln2": norm_defs(cfg, L),
                          **rwkv_mod.rwkv_defs(cfg, L)}
    else:
        defs["blocks"] = _block_defs(cfg, L)
        if cfg.family == "vlm":
            defs["frontend_proj"] = ParamDef((cfg.d_model, cfg.d_model),
                                             ("embed_fsdp", None))
    return defs


def cache_defs(cfg: ModelConfig, batch: int, seq: int) -> Tree:
    """Decode-cache ParamDef tree.  Dense, moe and vlm: per-layer K and V,
    ``[L, B, C, KV, hd]`` in the compute dtype, where C is ``seq`` or, for
    a sliding-window config, at most the window (a ring buffer).  Hybrid:
    the shared block's K and V a group under ``attn`` (``[G, B, C, KV,
    hd]``), and each Mamba2 layer's SSM state ``[G, attn_every, B, H, P,
    N]`` and conv tail ``[G, attn_every, B, CONV_K - 1, d_inner + 2 N]``,
    in the compute dtype.  rwkv: per-layer WKV state ``[L, B, H, 64, 64]``
    in f32 and the two token-shift inputs ``[L, B, D]`` in the compute
    dtype, whatever ``seq``."""
    _require_family(cfg)
    dt = compute_dtype(cfg)
    if cfg.family == "rwkv":
        H, hd = cfg.d_model // rwkv_mod.HEAD, rwkv_mod.HEAD
        shift = ParamDef((cfg.n_layers, batch, cfg.d_model),
                         ("layers", "cache_batch", None), init="zeros", dtype=dt)
        return {"wkv": ParamDef((cfg.n_layers, batch, H, hd, hd),
                                ("layers", "cache_batch", "state", None, None),
                                init="zeros", dtype=torch.float32),
                "shift_att": shift, "shift_ffn": shift}
    cache_len = min(seq, cfg.window) if cfg.window else seq
    n = _groups(cfg) if cfg.family == "hybrid" else cfg.n_layers
    shape = (n, batch, cache_len, cfg.kv_heads_c, cfg.head_dim)
    axes = ("layers", "cache_batch", "cache_seq", "kv", None)
    kv = {k: ParamDef(shape, axes, init="zeros", dtype=dt) for k in ("k", "v")}
    if cfg.family != "hybrid":
        return kv
    G, K = _groups(cfg), cfg.attn_every
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "attn": kv,
        "ssm_state": ParamDef((G, K, batch, H, P, N),
                              ("layers", "layers", "cache_batch", "state",
                               None, None), init="zeros", dtype=dt),
        "conv": ParamDef((G, K, batch, ssm_mod.CONV_K - 1,
                          cfg.d_inner + 2 * N),
                         ("layers", "layers", "cache_batch", None, "mlp"),
                         init="zeros", dtype=dt),
    }


class _Level(nn.Module):
    """A tree level that holds both leaves and subtrees (a moe layer's
    experts beside its ``shared`` expert): the leaves as parameters, the
    subtrees as submodules, in the tree's key order."""

    def __init__(self, tree: Tree):
        super().__init__()
        self._order = list(tree)
        for k, x in tree.items():
            if isinstance(x, torch.Tensor):
                self.register_parameter(
                    k, nn.Parameter(x, requires_grad=False))
            else:
                self.add_module(k, _module(x))


def _module(tree: Tree) -> nn.Module:
    if all(isinstance(x, torch.Tensor) for x in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(x, requires_grad=False) for k, x in tree.items()})
    if any(isinstance(x, torch.Tensor) for x in tree.values()):
        return _Level(tree)
    return nn.ModuleDict({k: _module(x) for k, x in tree.items()})


def _tree(m: nn.Module) -> Tree:
    if isinstance(m, nn.ParameterDict):
        return dict(m.items())
    if isinstance(m, _Level):
        return {k: getattr(m, k) if k in m._parameters else _tree(getattr(m, k))
                for k in m._order}
    return {k: _tree(x) for k, x in m.items()}


class LM(_Level):
    """An LM's parameters in the JAX package's tree: one submodule per dict
    level, one parameter per leaf, layers stacked on a leading ``[L]`` axis,
    so ``state_dict()`` keys are the JAX tree's paths (``blocks.attn.wq``,
    a vlm model's ``frontend_proj`` beside them, an encoder-decoder's
    ``decoder.cross_attn.wk``).  ``lm[name]`` and ``items()`` read the top
    level as a dict does.

    The leaves are created frozen: serving wants them so, and frozen
    leaves may be edited in place.  ``requires_grad_()`` makes them
    trainable, and ``loss_fn`` of the module then back-propagates into each
    leaf's ``.grad``; the trainer keeps the module frozen and
    differentiates its own per-layer view of the leaves
    (``runtime.trainer``)."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def items(self):
        return [(k, self[k]) for k in self._order]

    def tree(self) -> Tree:
        return _tree(self)


def _layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked tree (views, no copies), or of a tree whose
    stacked leaves are sequences of per-layer tensors."""
    return {k: _layer(x, i) if isinstance(x, dict) else x[i]
            for k, x in tree.items()}


# ---------------------------------------------------------------------------
# transformer block
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    y = mm(x, w.reshape(w.shape[0], -1).to(x.dtype))
    return y.unflatten(-1, w.shape[1:])


def _attention_sublayer(cfg, p, h, positions, rules, mesh, *, cache=None,
                        pos=None, window):
    dt = h.dtype
    B, S, D = h.shape
    pa = p["attn"]
    a = apply_norm(p["ln1"], h, cfg)
    q, k, v = _proj(a, pa["wq"]), _proj(a, pa["wk"]), _proj(a, pa["wv"])
    if cfg.qk_norm:
        q = rms_norm_simple(q) * pa["q_norm"].to(dt)
        k = rms_norm_simple(k) * pa["k_norm"].to(dt)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    q = constrain(q, ("batch", None, "heads", None), rules, mesh)
    k = constrain(k, ("batch", None, "kv", None), rules, mesh)

    if cache is None:
        o = attn.attend(cfg, q, k, v, causal=True, window=window)
        new_cache = {"k": k, "v": v}
    else:
        # The cache is this layer's view of the caller's [L, ...] tensors
        # and is written in place (the JAX package returns a new tree): that
        # saves a copy of the layer's cache at every layer and step.
        ck, cv = cache["k"], cache["v"]
        C = ck.shape[1]
        slot = pos % C if cfg.window else min(pos, C - 1)  # ring for SWA
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        if cfg.window:
            o = attn.decode_attention(q, ck, cv, pos=min(pos, C - 1))
        else:
            o = attn.decode_attention(q, ck, cv, pos=pos, window=window)
        new_cache = cache
    o = mm(o.reshape(B, S, -1), pa["wo"].reshape(-1, D).to(dt))
    o = constrain(o, ("act_batch", "act_seq", "act_embed"), rules, mesh)
    return h + o, new_cache


def _block(cfg, p, h, positions, rules, mesh, *, cache=None, pos=None):
    """One transformer layer (dense, moe, and hybrid's shared block);
    returns (h, the layer's K/V or its updated cache, the layer's aux:
    the moe balance loss, else 0)."""
    h, new_cache = _attention_sublayer(
        cfg, p, h, positions, rules, mesh, cache=cache, pos=pos,
        window=cfg.window)
    m = apply_norm(p["ln2"], h, cfg)
    if "moe" in p:
        y, aux = moe_mod.apply_moe(p["moe"], m, cfg, rules, mesh)
    else:
        y = apply_mlp(p["mlp"], m, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    y = constrain(y, ("act_batch", "act_seq", "act_embed"), rules, mesh)
    h = constrain(h + y, ("act_batch", "act_seq", "act_embed"), rules, mesh)
    return h, new_cache, aux


def _rwkv_block(cfg, p, h, rules, mesh, *, cache=None):
    """One rwkv layer; returns (h, the layer's cache after it)."""
    a = apply_norm(p["ln1"], h, cfg)
    y, c_att = rwkv_mod.apply_time_mix(p["time_mix"], a, cfg, cache=cache)
    h = h + y
    m = apply_norm(p["ln2"], h, cfg)
    y, c_ffn = rwkv_mod.apply_channel_mix(p["channel_mix"], m, cfg,
                                          cache=cache)
    h = constrain(h + y, ("act_batch", "act_seq", "act_embed"), rules, mesh)
    return h, {**c_att, **c_ffn}


# ---------------------------------------------------------------------------
# full forward passes
# ---------------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Keep matrix products' outputs, recompute the rest
    (``jax.checkpoint_policies.checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(cfg, fn):
    """``fn`` (one layer) checkpointed under ``cfg.remat``, as the
    reference's scan body: policy ``"nothing"`` recomputes the whole layer
    in the backward pass, ``"dots"`` keeps the matrix products' outputs
    (selective checkpointing)."""
    if not cfg.remat:
        return fn
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _save_dots)
                  if cfg.remat_policy == "dots" else None)
    return lambda *args: checkpointed(fn, *args, context_fn=context_fn)


def _stack(caches: list) -> Tree:
    """Per-layer cache trees stacked on a new leading axis."""
    return {n: _stack([c[n] for c in caches]) if isinstance(caches[0][n], dict)
            else torch.stack([c[n] for c in caches]) for n in caches[0]}


def _stack_forward(cfg, params, h, positions, rules, mesh,
                   collect_cache: bool):
    """The layers in turn, each under :func:`_maybe_remat`; returns (h,
    cache tree or None, the layers' aux summed)."""
    def layer(h, lp):
        if cfg.family == "rwkv":
            h, c = _rwkv_block(cfg, lp, h, rules, mesh)
            return h, c, torch.zeros((), dtype=torch.float32, device=h.device)
        return _block(cfg, lp, h, positions, rules, mesh)

    layer = _maybe_remat(cfg, layer)
    cache = kv = None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        h, kv, a = layer(h, _layer(params["blocks"], i))
        aux = aux + a
        if collect_cache:
            # each layer written into [L, ...] local shards as it comes (a
            # DTensor's own new_empty would be replicated on every rank)
            if cache is None:
                cache = {n: local(t).new_empty((cfg.n_layers,)
                                               + local(t).shape)
                         for n, t in kv.items()}
            for n, t in kv.items():
                cache[n][i] = local(t)
    if cache is not None:
        cache = {n: _stacked_like(c, kv[n]) for n, c in cache.items()}
    return h, cache, aux


def _stacked_like(c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A rank's ``[L, ...]`` cache shard ``c`` in the layout of its
    layers' tensor ``t``: a DTensor of ``t``'s placements one dim on, or
    ``c`` itself."""
    mesh = mesh_of(t)
    if mesh is None:
        return c
    from torch.distributed.tensor import Shard
    place = [Shard(p.dim + 1) if p.is_shard() else p for p in t.placements]
    return from_local_as(c, mesh, place, (c.shape[0],) + t.shape)


def _hybrid_forward(cfg, params, h, positions, rules, mesh,
                    collect_cache: bool):
    """Each group's ``attn_every`` Mamba2 layers, each added to the
    residual with no norm in front (as the reference), then the shared
    block; each group under :func:`_maybe_remat`.  Returns (h, the decode
    cache or None, the summed aux)."""
    shared = params["shared_attn"]

    def group(h, gp):
        ssm = []
        for j in range(cfg.attn_every):
            o, c = ssm_mod.apply_ssm(_layer(gp, j), h, cfg)
            h = constrain(h + o, ("act_batch", "act_seq", "act_embed"),
                          rules, mesh)
            ssm.append(c)
        h, kv, a = _block(cfg, shared, h, positions, rules, mesh)
        return h, ((kv, _stack(ssm)) if collect_cache else None), a

    group = _maybe_remat(cfg, group)
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(_groups(cfg)):
        h, c, a = group(h, _layer(params["mamba"], g))
        aux = aux + a
        caches.append(c)
    if not collect_cache:
        return h, None, aux
    kv, ssm = _stack([c[0] for c in caches]), _stack([c[1] for c in caches])
    return h, {"attn": kv, **ssm}, aux


def _embed_inputs(cfg, params, batch, rules, mesh):
    """Token embedding, for vlm behind the projected ``batch["patches"]``
    ``[B, n_front, D]`` where the batch has them; returns (h, positions,
    n_front).  Under a mesh the tokens and positions join it replicated
    (DTensor's vocab-sharded lookup mis-sizes its mask when the ids are
    sharded over another mesh dim), and the embeddings go to their ranks."""
    tokens = like(batch["tokens"], params["embed"]["tok"])
    h = embed_tokens(params["embed"], tokens, cfg)
    n_front = 0
    if cfg.family == "vlm" and "patches" in batch:
        dt = h.dtype
        patches = constrain(batch["patches"], ("batch", None, None), rules,
                            mesh)
        pat = mm(patches.to(dt), params["frontend_proj"].to(dt))
        h = torch.cat([pat, h], dim=1)
        n_front = pat.shape[1]
    positions = like(torch.arange(h.shape[1], dtype=torch.int32,
                                  device=h.device)[None, :], h)
    h = constrain(h, ("act_batch", "act_seq", "act_embed"), rules, mesh)
    return h, positions, n_front


def _backbone(params, batch, cfg: ModelConfig, *, rules, mesh,
              collect_cache):
    """Embed + blocks + final norm; returns (h of the text positions,
    cache, aux).  A vlm cache covers the patches' positions too."""
    _require_family(cfg)
    h, positions, n_front = _embed_inputs(cfg, params, batch, rules, mesh)
    fwd = _hybrid_forward if cfg.family == "hybrid" else _stack_forward
    h, cache, aux = fwd(cfg, params, h, positions, rules, mesh,
                        collect_cache)
    h = apply_norm(params["final_norm"], h, cfg)
    return (h[:, n_front:] if n_front else h), cache, aux


def forward(params: LM, batch, cfg: ModelConfig, *,
            rules: ShardingRules = TRAIN_RULES, mesh=None,
            collect_cache=False, last_only: bool = False):
    """Full-sequence forward.  Returns (logits, cache or None).

    ``last_only`` computes logits for the final position only (prefill never
    pays the [B, S, V] unembed).  Under ``mesh`` (a ``DeviceMesh``) the
    parameters are DTensors laid out by ``rules`` (``ModelAPI.param_specs``)
    and so are the logits and the cache.
    """
    params = params.tree() if isinstance(params, LM) else params
    h, cache, _ = _backbone(params, batch, cfg, rules=rules, mesh=mesh,
                            collect_cache=collect_cache)
    if last_only:
        h = h[:, -1:]
    logits = logits_from_hidden(params["embed"], h, cfg)
    return constrain(logits, ("batch", None, "vocab"), rules, mesh), cache


def loss_fn(params, batch, cfg: ModelConfig, *,
            rules: ShardingRules = TRAIN_RULES, mesh=None):
    """Mean next-token CE of ``batch["labels"]`` (``chunked_lm_loss``).
    Returns ``(loss + 0.01 * aux, {"ce", "aux"})``, where ``aux`` is the
    moe layers' balance loss summed over the layers (0 for the other
    families).

    ``params`` is an ``LM`` or its tree, whose stacked layer leaves may be
    sequences of per-layer tensors.  Under ``mesh`` the batch is the full
    batch on every rank (each rank takes its rows) and the loss a
    replicated DTensor."""
    params = params.tree() if isinstance(params, LM) else params
    h, _, aux = _backbone(params, batch, cfg, rules=rules, mesh=mesh,
                          collect_cache=False)
    labels = constrain(batch["labels"], ("batch", None), rules, mesh)
    loss = chunked_lm_loss(params["embed"], h, labels, cfg, rules, mesh)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: LM, batch, cfg: ModelConfig, *,
            rules: ShardingRules = TRAIN_RULES, mesh=None):
    """Process a full prompt; emit last-position logits and a cache.

    Dense, moe and vlm: the per-layer K/V of every prompt position,
    ``[L, B, S, KV, hd]`` (for vlm S counts the patches, which come first:
    decoding goes on at position S).  Hybrid: the decode cache but for the
    length of its K/V, the shared block's K/V of every prompt position a
    group
    (``{"attn": {"k", "v"}}``, ``[G, B, S, KV, hd]``) and each Mamba2
    layer's final SSM state and conv tail.  rwkv: the decode cache itself
    (``cache_defs``), the per-layer final WKV state and the last prompt
    position of the ln1 and ln2 outputs that enter the token shifts.  (The
    JAX package's ``prefill`` returns no cache for rwkv and only the K/V
    for hybrid; its ``serve_batch`` builds the cache through decode steps
    instead.)"""
    logits, cache = forward(params, batch, cfg, rules=rules, mesh=mesh,
                            collect_cache=True, last_only=True)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(params: LM, tokens: torch.Tensor, pos: int, cache: Tree,
                cfg: ModelConfig, *, rules: ShardingRules = TRAIN_RULES,
                mesh=None):
    """One decode step.  tokens: [B] ints; pos: the position they take;
    cache: the ``cache_defs`` tree, updated in place and returned (under
    ``mesh``, prefill's DTensor cache)."""
    _require_family(cfg)
    params = params.tree() if isinstance(params, LM) else params
    tokens = like(tokens, params["embed"]["tok"])    # as _embed_inputs
    h = embed_tokens(params["embed"], tokens[:, None], cfg)
    h = constrain(h, ("act_batch", None, "act_embed"), rules, mesh)
    positions = like(torch.full((1, 1), pos, dtype=torch.int32,
                                device=h.device), h)
    if cfg.family == "hybrid":
        kv = cache["attn"]
        for g in range(_groups(cfg)):
            gp = _layer(params["mamba"], g)
            for j in range(cfg.attn_every):
                o, new = ssm_mod.apply_ssm(
                    _layer(gp, j), h, cfg,
                    cache={n: cache[n][g, j] for n in ("ssm_state", "conv")})
                h = h + o
                for n, t in new.items():  # in place, as the K/V
                    cache[n][g, j] = t
            h, _, _ = _block(cfg, params["shared_attn"], h, positions,
                             rules, mesh,
                             cache={n: t[g] for n, t in kv.items()}, pos=pos)
    else:
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            layer_cache = {n: t[i] for n, t in cache.items()}
            if cfg.family == "rwkv":
                h, new = _rwkv_block(cfg, lp, h, rules, mesh,
                                     cache=layer_cache)
                for n, t in new.items():      # in place, as the dense K/V
                    cache[n][i] = t
            else:
                h, _, _ = _block(cfg, lp, h, positions, rules, mesh,
                                 cache=layer_cache, pos=pos)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = logits_from_hidden(params["embed"], h, cfg)[:, 0]
    return constrain(logits, ("act_batch", "vocab"), rules, mesh), cache
