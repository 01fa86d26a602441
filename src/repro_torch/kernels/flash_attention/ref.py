"""Plain PyTorch version of flash attention: naive, materializes the scores,
f32 math.  The kernel in ``csrc/flash_attention.cu`` is held to it."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    q_offset: int = 0,
):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, KV, hd] -> [B, Sq, H, hd], f32 math."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, hd)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * (hd ** -0.5)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, vf)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
