"""GQA attention: the blockwise path and the hand-written kernel's path.

Counterpart of ``repro.models.attention``.  ``blockwise_attention`` is an
online softmax over KV tiles with the GQA grouped einsum (KV heads never
widened to the query heads), causal and sliding-window masks and a
key-validity mask.  ``attend`` takes the CUDA kernel
(``repro_torch.kernels.flash_attention``) when ``cfg.use_pallas`` is set,
as the JAX package takes its Pallas kernel, and ``blockwise_attention``
otherwise.  ``decode_attention`` is plain tensor code in both packages.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.sharding.rules import ParamDef

NEG_INF = -1e30


def attn_defs(cfg: ModelConfig, layers: tuple[int, ...] = (), d_model: int | None = None):
    D = d_model or cfg.d_model
    H, KV, hd = cfg.heads_c, cfg.kv_heads_c, cfg.head_dim
    lx = ("layers",) * len(layers)
    d = {
        "wq": ParamDef(layers + (D, H, hd), lx + ("embed_fsdp", "heads", None)),
        "wk": ParamDef(layers + (D, KV, hd), lx + ("embed_fsdp", "kv", None)),
        "wv": ParamDef(layers + (D, KV, hd), lx + ("embed_fsdp", "kv", None)),
        "wo": ParamDef(layers + (H, hd, D), lx + ("heads", None, "embed_fsdp")),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef(layers + (hd,), lx + (None,), init="ones")
        d["k_norm"] = ParamDef(layers + (hd,), lx + (None,), init="ones")
    return d


def _mask_block(
    q_pos: torch.Tensor,     # [Sq]
    k_pos: torch.Tensor,     # [Bk]
    causal: bool,
    window: Optional[int],
    k_valid: Optional[torch.Tensor] = None,  # [Bk] bool (cache fill mask)
) -> torch.Tensor:
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    if k_valid is not None:
        m &= k_valid[None, :]
    return m


def _block_attn(q, k, v, q_pos, k_pos, *, causal, window, scale, k_valid=None):
    """One (q-tile x kv-tile) online-softmax update step.

    q: [B, Sq, KV, G, hd]   k/v: [B, Bk, KV, hd]
    returns partial (m, l, acc) update terms.
    """
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    mask = _mask_block(q_pos, k_pos, causal, window, k_valid)   # [Sq, Bk]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.amax(s, dim=-1)                                # [B,KV,G,Sq]
    p = torch.exp(s - m_new[..., None])
    l_new = torch.sum(p, dim=-1)
    acc_new = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype), v)
    return m_new, l_new, acc_new


def _combine(m1, l1, a1, m2, l2, a2):
    m = torch.maximum(m1, m2)
    e1 = torch.exp(m1 - m)
    e2 = torch.exp(m2 - m)
    l = l1 * e1 + l2 * e2
    a = a1 * e1[..., None].to(a1.dtype) + a2 * e2[..., None].to(a2.dtype)
    return m, l, a


def blockwise_attention(
    q: torch.Tensor,              # [B, Sq, H, hd]
    k: torch.Tensor,              # [B, Sk, KV, hd]
    v: torch.Tensor,              # [B, Sk, KV, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    block_q: int = 512,
    block_k: int = 512,
    k_valid: Optional[torch.Tensor] = None,   # [Sk] bool, or [1, Sk]
) -> torch.Tensor:
    """Attention that never materializes the [Sq, Sk] scores: a loop over
    query tiles, each an online softmax over key tiles."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, hd)

    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    kv_valid = torch.arange(Sk, device=dev) < Sk
    if k_valid is not None:
        kv_valid = kv_valid & k_valid.reshape(-1)
    q_positions = q_offset + torch.arange(Sq, device=dev)
    k_positions = torch.arange(Sk, device=dev)

    # Ragged last tiles stand for the JAX package's padding to tile
    # multiples (a padded key is masked, a padded query row dropped); the two
    # agree on every row that sees at least one key.
    outs = []
    for q0 in range(0, Sq, block_q):
        qt, qp = qg[:, q0:q0 + block_q], q_positions[q0:q0 + block_q]
        n = qt.shape[1]
        m = torch.full((B, KV, G, n), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, n), dtype=torch.float32, device=dev)
        a = torch.zeros((B, KV, G, n, hd), dtype=qt.dtype, device=dev)
        for k0 in range(0, Sk, block_k):
            sl = slice(k0, k0 + block_k)
            m2, l2, a2 = _block_attn(
                qt, k[:, sl], v[:, sl], qp, k_positions[sl], causal=causal,
                window=window, scale=scale, k_valid=kv_valid[sl])
            m, l, a = _combine(m, l, a, m2, l2, a2)
        outs.append(a / torch.clamp(l, min=1e-30)[..., None].to(a.dtype))
    out = torch.cat(outs, dim=3)                          # [B,KV,G,Sq,hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def decode_attention(
    q: torch.Tensor,              # [B, 1, H, hd]
    k_cache: torch.Tensor,        # [B, S, KV, hd]
    v_cache: torch.Tensor,
    *,
    pos: int,                     # current position (# valid cache entries - 1)
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode: scores fit in memory; one fused softmax."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float()
    s = s * (hd ** -0.5)
    kpos = torch.arange(S, device=q.device)
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


def attend(
    cfg: ModelConfig,
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool, window=None, q_offset=0, k_valid=None,
) -> torch.Tensor:
    if cfg.use_pallas:
        return flash_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            block_q=cfg.block_q, block_k=cfg.block_k,
        )
    return blockwise_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        block_q=cfg.block_q, block_k=cfg.block_k, k_valid=k_valid,
    )
