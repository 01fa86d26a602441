"""Shared neural building blocks: plain functions on tensors.

Counterpart of ``repro.models.layers`` (norms, MLP, rotary embeddings,
embeddings and logits, the training loss).  Parameters are nested dicts of
tensors with the JAX package's names and shapes; weights are kept in f32
and cast to the activations' dtype at use, as there.

Where the reference wraps a step in ``jax.checkpoint`` (a loss chunk, a
KV tile, a WKV chunk, a layer under ``cfg.remat``), the port calls it
through :func:`checkpointed`: while autograd records, the step's
activations are recomputed in the backward pass instead of kept; under
``no_grad`` or ``inference_mode`` the step simply runs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.rules import (
    ParamDef, constrain, gather_inner, like, mesh_of,
)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def checkpointed(fn, *args, context_fn=None):
    """``fn(*args)``, its activations recomputed in the backward pass when
    autograd records (``jax.checkpoint``); ``context_fn`` selects what is
    kept instead (see ``lm._maybe_remat``)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False, **kw)


class _WholeGrad(torch.autograd.Function):
    """The identity, whose gradient comes back with its inner dims whole
    (``gather_inner``)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return gather_inner(g)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over ``x``'s last dim.  Under a mesh ``x``'s inner dims
    (the sequence) are gathered first, and so is the gradient that comes
    back to the product's output: the product flattens ``[B, S]`` into
    rows, which DTensor's view rule takes only with ``S`` whole, and a
    sequence-parallel layout (``act_seq``) hands the backward pass a
    gradient sharded along ``S``."""
    if mesh_of(x) is None:
        return x @ w
    return _WholeGrad.apply(gather_inner(x) @ w)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig, layers: tuple[int, ...] = ()):
    d = {"scale": ParamDef(layers + (cfg.d_model,),
                           ("layers",) * len(layers) + (None,), init="ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDef(layers + (cfg.d_model,),
                             ("layers",) * len(layers) + (None,), init="zeros")
    return d


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig, eps: float = 1e-5) -> torch.Tensor:
    """The norm of ``x``'s last dim; under a mesh its output has the
    sequence whole (``gather_inner``: it enters the layer's products)."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        out = xf * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    return gather_inner(out.to(x.dtype))


def rms_norm_simple(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
            ).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, layers: tuple[int, ...] = (), d_ff: int | None = None):
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    lx = ("layers",) * len(layers)
    d = {
        "wi": ParamDef(layers + (D, F_), lx + ("embed_fsdp", "mlp")),
        "wo": ParamDef(layers + (F_, D), lx + ("mlp", "embed_fsdp")),
    }
    if cfg.act == "swiglu":
        d["wg"] = ParamDef(layers + (D, F_), lx + ("embed_fsdp", "mlp"))
    return d


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    h = mm(x, p["wi"].to(dt))
    if cfg.act == "swiglu":
        h = F.silu(mm(x, p["wg"].to(dt))) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return mm(h, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# rotary position embeddings (RoPE / partial rotary)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, rotary_pct: float, theta: float, device=None):
    rot = int(head_dim * rotary_pct) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    inv, rot = rope_freqs(x.shape[-1], cfg.rotary_pct, cfg.rope_theta,
                          device=x.device)
    if rot == 0:
        return x
    # [..., S, rot/2]
    ang = positions[..., :, None].float() * like(inv, positions)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig):
    d = {"tok": ParamDef((cfg.vocab_c, cfg.d_model), ("vocab", "embed_fsdp"),
                         init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab_c), ("embed_fsdp", "vocab"))
    return d


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # Gather, then cast: the same values as casting the whole table first.
    # F.embedding, not indexing: its CUDA backward sums the rows of repeated
    # tokens in a fixed order, where indexing's (an accumulating index_put_)
    # adds them with atomics, so a replayed training step would not repeat
    # its embedding gradient bit for bit.
    h = F.embedding(tokens, p["tok"])
    mesh = mesh_of(h)
    if mesh is not None:
        # a vocab-sharded lookup leaves masked partial rows, which the
        # next op (a norm, a concat) cannot take: summed here, exactly
        # (one rank holds each row)
        from torch.distributed.tensor import Replicate
        h = h.redistribute(mesh, [Replicate() if q.is_partial() else q
                                  for q in h.placements])
    return h.to(compute_dtype(cfg))


def logits_from_hidden(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.tie_embeddings:
        return mm(x, p["tok"].to(dt).T)
    return mm(x, p["unembed"].to(dt))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in f32; labels [B, S] ints."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _chunk_nll(embed_p, cfg, hc, lc, rules, mesh):
    """(sum of the chunk's NLL, its count of labels >= 0)."""
    logits = logits_from_hidden(embed_p, hc, cfg)
    lf = constrain(logits, ("batch", None, "vocab"), rules, mesh).float()
    if mesh is None:
        lse = torch.logsumexp(lf, dim=-1)                 # [B, chunk]
    else:
        # the log-sum-exp over a vocab sharded over ranks, from the max
        # and sum reductions DTensor shards (it has no logsumexp rule)
        top = torch.amax(lf, dim=-1).detach()
        lse = top + torch.log(torch.sum(torch.exp(lf - top[..., None]),
                                        dim=-1))
    # the gold logit by a select over the vocab, as the reference takes it
    # (its gradient is the reference's; a gather's would scatter)
    iota = like(torch.arange(lf.shape[-1], device=lf.device), lf)
    gold = torch.sum(torch.where(iota == lc[..., None], lf, 0.0), dim=-1)
    valid = (lc >= 0).float()
    nll = (lse - gold) * valid
    return torch.sum(nll), torch.sum(valid)


def chunked_lm_loss(embed_p, h: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig, rules=None, mesh=None, *,
                    chunk: int = 1024) -> torch.Tensor:
    """Fused unembed + CE over sequence chunks: mean NLL of the labels >= 0.

    Never materializes the [B, S, V] logits: per chunk the [B, chunk, V]
    logits are computed, reduced to (lse, gold) and dropped, and the
    backward pass recomputes them chunk by chunk.  The sequence is padded
    to a chunk multiple with label -1, which counts nowhere.  Under a mesh
    each chunk's logits are laid out by ``rules`` (the vocab on ``model``
    under the training rules: the log-sum-exp reduces over the shards).
    """
    B, S, D = h.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    total = like(torch.zeros((), dtype=torch.float32, device=h.device), h)
    count = like(torch.zeros((), dtype=torch.float32, device=h.device), h)
    for c0 in range(0, S + pad, chunk):
        nll, n = checkpointed(
            lambda hc, lc: _chunk_nll(embed_p, cfg, hc, lc, rules, mesh),
            h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        total, count = total + nll, count + n
    return total / torch.clamp(count, min=1.0)
