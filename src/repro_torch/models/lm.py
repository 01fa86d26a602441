"""Decoder-only LM, dense and rwkv families: parameters, full forward,
prefill, decode.

Counterpart of the dense and rwkv parts of ``repro.models.lm``.  One
declarative ``param_defs`` tree with stacked ``[L, ...]`` layer leaves, the
JAX package's names and shapes, held in an :class:`LM` module; the building
blocks are plain functions on its tree:

    forward(params, batch, cfg)                -> (logits, cache or None)
    prefill(params, batch, cfg)                -> (last_logits, cache)
    decode_step(params, tokens, pos, cache, cfg) -> (logits, cache)

A Python loop over the layers takes the place of ``lax.scan``.  The
projections and the unembedding are plain matrix products; attention over
the whole sequence goes through ``attention.attend``, which runs the CUDA
kernel when ``cfg.use_pallas`` is set, and the rwkv time-mix over the whole
sequence through ``rwkv.apply_time_mix``, which runs the ``linattn_scan``
CUDA kernel when it is set.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (
    apply_mlp, apply_norm, apply_rope, compute_dtype, embed_defs,
    embed_tokens, logits_from_hidden, mlp_defs, norm_defs, rms_norm_simple,
)
from repro_torch.sharding.rules import ParamDef

Tree = Dict[str, Any]


PORTED_FAMILIES = ("dense", "rwkv")


def require_ported(cfg: ModelConfig) -> None:
    """The port carries the dense and rwkv families so far; the others
    raise."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to PyTorch "
            "yet (ROADMAP Queue 1 item 10: moe, hybrid, vlm and encdec come "
            "after the dense and rwkv families)")


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _block_defs(cfg: ModelConfig, layers: tuple[int, ...]):
    return {
        "ln1": norm_defs(cfg, layers),
        "attn": attn.attn_defs(cfg, layers),
        "ln2": norm_defs(cfg, layers),
        "mlp": mlp_defs(cfg, layers),
    }


def param_defs(cfg: ModelConfig) -> Tree:
    require_ported(cfg)
    L = (cfg.n_layers,)
    if cfg.family == "rwkv":
        blocks = {"ln1": norm_defs(cfg, L), "ln2": norm_defs(cfg, L),
                  **rwkv_mod.rwkv_defs(cfg, L)}
    else:
        blocks = _block_defs(cfg, L)
    return {"embed": embed_defs(cfg), "final_norm": norm_defs(cfg),
            "blocks": blocks}


def cache_defs(cfg: ModelConfig, batch: int, seq: int) -> Tree:
    """Decode-cache ParamDef tree.  Dense: per-layer K and V,
    ``[L, B, C, KV, hd]`` in the compute dtype, where C is ``seq`` or, for
    a sliding-window config, at most the window (a ring buffer).  rwkv:
    per-layer WKV state ``[L, B, H, 64, 64]`` in f32 and the two token-shift
    inputs ``[L, B, D]`` in the compute dtype, whatever ``seq``."""
    require_ported(cfg)
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
    shape = (cfg.n_layers, batch, cache_len, cfg.kv_heads_c, cfg.head_dim)
    axes = ("layers", "cache_batch", "cache_seq", "kv", None)
    return {n: ParamDef(shape, axes, init="zeros", dtype=dt) for n in ("k", "v")}


def _module(tree: Tree) -> nn.Module:
    if all(isinstance(x, torch.Tensor) for x in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(x, requires_grad=False) for k, x in tree.items()})
    if any(isinstance(x, torch.Tensor) for x in tree.values()):
        raise ValueError(f"a tree level mixes leaves and subtrees: {sorted(tree)}")
    return nn.ModuleDict({k: _module(x) for k, x in tree.items()})


def _tree(m: nn.Module) -> Tree:
    if isinstance(m, nn.ParameterDict):
        return dict(m.items())
    return {k: _tree(x) for k, x in m.items()}


class LM(nn.ModuleDict):
    """An LM's parameters in the JAX package's tree: one submodule per dict
    level, one parameter per leaf, layers stacked on a leading ``[L]`` axis,
    so ``state_dict()`` keys are the JAX tree's paths (``blocks.attn.wq``)."""

    def __init__(self, tree: Tree):
        super().__init__({k: _module(x) for k, x in tree.items()})

    def tree(self) -> Tree:
        return {k: _tree(x) for k, x in self.items()}


def _layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return {k: _layer(x, i) if isinstance(x, dict) else x[i]
            for k, x in tree.items()}


# ---------------------------------------------------------------------------
# transformer block
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    y = x @ w.reshape(w.shape[0], -1).to(x.dtype)
    return y.unflatten(-1, w.shape[1:])


def _attention_sublayer(cfg, p, h, positions, *, cache=None, pos=None,
                        window):
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
    o = o.reshape(B, S, -1) @ pa["wo"].reshape(-1, D).to(dt)
    return h + o, new_cache


def _block(cfg, p, h, positions, *, cache=None, pos=None):
    h, new_cache = _attention_sublayer(
        cfg, p, h, positions, cache=cache, pos=pos, window=cfg.window)
    m = apply_norm(p["ln2"], h, cfg)
    return h + apply_mlp(p["mlp"], m, cfg), new_cache


def _rwkv_block(cfg, p, h, *, cache=None):
    """One rwkv layer; returns (h, the layer's cache after it)."""
    a = apply_norm(p["ln1"], h, cfg)
    y, c_att = rwkv_mod.apply_time_mix(p["time_mix"], a, cfg, cache=cache)
    h = h + y
    m = apply_norm(p["ln2"], h, cfg)
    y, c_ffn = rwkv_mod.apply_channel_mix(p["channel_mix"], m, cfg,
                                          cache=cache)
    return h + y, {**c_att, **c_ffn}


# ---------------------------------------------------------------------------
# full forward passes
# ---------------------------------------------------------------------------

def _stack_forward(cfg, params, h, positions, collect_cache: bool):
    """The layers in turn; returns (h, cache tree or None)."""
    cache = None
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        if cfg.family == "rwkv":
            h, kv = _rwkv_block(cfg, lp, h)
        else:
            h, kv = _block(cfg, lp, h, positions)
        if collect_cache:
            if cache is None:
                cache = {n: t.new_empty((cfg.n_layers,) + t.shape)
                         for n, t in kv.items()}
            for n, t in kv.items():
                cache[n][i] = t
    return h, cache


def _embed_inputs(cfg, params, batch):
    """Token embedding; returns (h, positions)."""
    tokens = batch["tokens"]
    h = embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(h.shape[1], dtype=torch.int32,
                             device=h.device)[None, :]
    return h, positions


def _backbone(params, batch, cfg: ModelConfig, *, collect_cache):
    """Embed + blocks + final norm; returns (h, cache)."""
    require_ported(cfg)
    h, positions = _embed_inputs(cfg, params, batch)
    h, cache = _stack_forward(cfg, params, h, positions, collect_cache)
    return apply_norm(params["final_norm"], h, cfg), cache


def forward(params: LM, batch, cfg: ModelConfig, *, collect_cache=False,
            last_only: bool = False):
    """Full-sequence forward.  Returns (logits, cache or None).

    ``last_only`` computes logits for the final position only (prefill never
    pays the [B, S, V] unembed).
    """
    params = params.tree()
    h, cache = _backbone(params, batch, cfg, collect_cache=collect_cache)
    if last_only:
        h = h[:, -1:]
    return logits_from_hidden(params["embed"], h, cfg), cache


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def prefill(params: LM, batch, cfg: ModelConfig):
    """Process a full prompt; emit last-position logits and a cache.

    Dense: the per-layer K/V of every prompt position,
    ``[L, B, S, KV, hd]``.  rwkv: the decode cache itself (``cache_defs``),
    the per-layer final WKV state and the last prompt position of the ln1
    and ln2 outputs that enter the token shifts.  (The JAX package's
    ``prefill`` returns no cache for rwkv, and its ``serve_batch`` builds
    the cache through decode steps instead.)"""
    logits, cache = forward(params, batch, cfg, collect_cache=True,
                            last_only=True)
    return logits[:, -1], cache


def decode_step(params: LM, tokens: torch.Tensor, pos: int, cache: Tree,
                cfg: ModelConfig):
    """One decode step.  tokens: [B] ints; pos: the position they take;
    cache: the ``cache_defs`` tree, updated in place and returned."""
    require_ported(cfg)
    params = params.tree()
    h = embed_tokens(params["embed"], tokens[:, None], cfg)
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=h.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        layer_cache = {n: t[i] for n, t in cache.items()}
        if cfg.family == "rwkv":
            h, new = _rwkv_block(cfg, lp, h, cache=layer_cache)
            for n, t in new.items():      # in place, as the dense K/V
                cache[n][i] = t
        else:
            h, _ = _block(cfg, lp, h, positions, cache=layer_cache, pos=pos)
    h = apply_norm(params["final_norm"], h, cfg)
    return logits_from_hidden(params["embed"], h, cfg)[:, 0], cache
