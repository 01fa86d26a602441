"""Shared neural building blocks: plain functions on tensors.

Counterpart of ``repro.models.layers`` (norms, MLP, rotary embeddings,
embeddings and logits).  Parameters are nested dicts of tensors with the
JAX package's names and shapes; weights are kept in f32 and cast to the
activations' dtype at use, as there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.rules import ParamDef


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        out = xf * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


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
    h = x @ p["wi"].to(dt)
    if cfg.act == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ p["wo"].to(dt)


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
    ang = positions[..., :, None].float() * inv            # [..., S, rot/2]
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
    # gather, then cast: the same values as casting the whole table first
    return p["tok"][tokens].to(compute_dtype(cfg))


def logits_from_hidden(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.tie_embeddings:
        return x @ p["tok"].to(dt).T
    return x @ p["unembed"].to(dt)
