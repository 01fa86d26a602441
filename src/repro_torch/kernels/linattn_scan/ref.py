"""Plain PyTorch version of the chunked linear attention: a token-by-token
scan of the RWKV6 recurrence, f32 math.  The kernel in
``csrc/linattn_scan.cu`` is held to it.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t = exp(logw_t)
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
"""

from __future__ import annotations

import torch


def linattn_reference(r, k, v, logw, u):
    """r/k/v/logw: [B, H, S, K]; u: [H, K].

    Returns ``(y, state)``: y [B, H, S, K] in r's dtype and the final
    state [B, H, K, K] in f32, key axis first (``state[b, h, key, value]``).
    """
    B, H, S, K = r.shape
    rf, kf, vf = (a.float() for a in (r, k, v))
    w = torch.exp(logw.float())
    uf = u.float()[None, :, :, None]
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], state + uf * kv))
        state = w[:, :, t, :, None] * state + kv
    return torch.stack(ys, dim=2).to(r.dtype), state
