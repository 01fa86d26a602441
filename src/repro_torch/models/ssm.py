"""Mamba2 / SSD block (zamba2 backbone), chunked-scan formulation.

Counterpart of ``repro.models.ssm``.  State-space recurrence per head h
(state N, head dim P):

    S_t = a_t * S_{t-1} + x_t (dt_t B_t)^T        a_t = exp(dt_t * A_h)
    y_t = C_t . S_t + D_h * x_t

The full sequence takes the chunk-parallel form (Dao & Gu 2024): each
chunk's attention-like product under its decay mask, and the state
carried from chunk to chunk.  The reference scans the chunks one after
another; here every chunk's own terms are computed at once and only the
state hand-over is a loop (two element-wise operations a chunk).  Decode
takes the one-step recurrence.  No Pallas kernel is on this path in
either package.

Unlike the JAX package, :func:`apply_ssm` over the whole sequence also
returns the cache it leaves behind (the final SSM state and the conv
tail): the port's prefill hands it to decode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mm, rms_norm_simple
from repro_torch.sharding.rules import ParamDef, on_local_heads

CONV_K = 4  # depthwise causal conv width (mamba2 default)


def ssm_defs(cfg: ModelConfig, layers: tuple[int, ...] = ()):
    D, DI, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    conv_dim = DI + 2 * N
    lx = ("layers",) * len(layers)
    return {
        # in_proj emits [z (DI) | xBC (DI+2N) | dt (H)]
        "w_in": ParamDef(layers + (D, 2 * DI + 2 * N + H), lx + ("embed_fsdp", "mlp")),
        "conv_w": ParamDef(layers + (CONV_K, conv_dim), lx + (None, "mlp")),
        "conv_b": ParamDef(layers + (conv_dim,), lx + ("mlp",), init="zeros"),
        "A_log": ParamDef(layers + (H,), lx + (None,), init="zeros"),
        "D_skip": ParamDef(layers + (H,), lx + (None,), init="ones"),
        "dt_bias": ParamDef(layers + (H,), lx + (None,), init="zeros"),
        "norm_scale": ParamDef(layers + (DI,), lx + ("mlp",), init="ones"),
        "w_out": ParamDef(layers + (DI, D), lx + ("mlp", "embed_fsdp")),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    DI, N = cfg.d_inner, cfg.ssm_state
    return proj[..., :DI], proj[..., DI:2 * DI + 2 * N], proj[..., 2 * DI + 2 * N:]


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over seq. xBC: [B, S, Cd]; w: [K, Cd].

    Returns (out, new conv state): the state is the last ``CONV_K - 1``
    inputs before the conv, zeros in front when there are fewer."""
    B, S, Cd = xBC.shape
    if conv_state is None:
        conv_state = xBC.new_zeros((B, CONV_K - 1, Cd))
    xp = torch.cat([conv_state, xBC], dim=1)               # [B, S+K-1, Cd]
    out = 0
    for i in range(CONV_K):
        out = out + xp[:, i:i + S] * w[i]
    out = F.silu(out + b)
    return out, xp[:, -(CONV_K - 1):]


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunk-parallel SSD scan.

    x: [B, S, H, P]; dt: [B, S, H] (>0, already through the softplus); A:
    [H] (<0, f32); Bm/Cm: [B, S, N].  Returns y [B, S, H, P], final state
    [B, H, P, N] in x's dtype.  A ragged last chunk is padded with zeros,
    dt included: a padded step decays by 1 and adds nothing."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    dtype = x.dtype
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(a, (0, 0, 0, pad)) for a in (dt, Bm, Cm))
    nc = (S + pad) // Q
    xs = x.reshape(Bb, nc, Q, H, P)
    dts = dt.reshape(Bb, nc, Q, H)
    Bs, Cs = Bm.reshape(Bb, nc, Q, N), Cm.reshape(Bb, nc, Q, N)
    L = torch.cumsum(A * dts, dim=2)                   # [B, c, Q, H], f32
    # intra-chunk: M[t,i] = exp(L_t - L_i) * (C_t.B_i) * dt_i  (i <= t)
    seg = L[:, :, :, None, :] - L[:, :, None, :, :]    # [B, c, Q, Q, H]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(mask[:, :, None], seg, -torch.inf)
    cb = torch.einsum("bcqn,bcin->bcqi", Cs, Bs)
    M = torch.exp(seg) * cb[..., None] * dts[:, :, None, :, :]
    y_intra = torch.einsum("bcqih,bcihp->bcqhp", M.to(dtype), xs)
    # each chunk's own state: sum_i exp(L_Q - L_i) x_i (dt_i B_i)^T
    Lq = L[:, :, -1]                                   # [B, c, H]
    w_i = torch.exp(Lq[:, :, None] - L) * dts
    ds = torch.einsum("bcqh,bcqhp,bcqn->bchpn", w_i.to(dtype), xs, Bs)
    decay = torch.exp(Lq).to(dtype)
    state = x.new_zeros((Bb, H, P, N))
    before = []
    for c in range(nc):          # S' = exp(L_Q) S + ds, chunk by chunk
        before.append(state)
        state = decay[:, c, :, None, None] * state + ds[:, c]
    # inter-chunk: y += exp(L_t) * C_t . (the state before the chunk)
    y_inter = torch.einsum("bcqh,bcqn,bchpn->bcqhp", torch.exp(L).to(dtype),
                           Cs, torch.stack(before, dim=1))
    y = (y_intra + y_inter).reshape(Bb, nc * Q, H, P)[:, :S]
    return y, state


def scan_inputs(p, x: torch.Tensor, cfg: ModelConfig,
                conv_state: Optional[torch.Tensor] = None):
    """The block's input projection, causal conv and softplus: ``(z, xin
    [B, S, H, P], dt [B, S, H] f32, A [H] f32, Bm, Cm [B, S, N], conv
    state after the block)``, all but dt and A in x's dtype."""
    B, S, D = x.shape
    H, P, N, DI = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    dt_f = x.dtype
    proj = mm(x, p["w_in"].to(dt_f))
    z, xBC, dt_raw = _split_proj(cfg, proj)
    xBC, conv_state = _causal_conv(
        xBC, p["conv_w"].to(dt_f), p["conv_b"].to(dt_f), conv_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())                     # [H], negative
    return (z, xBC[..., :DI].reshape(B, S, H, P), dt, A, xBC[..., DI:DI + N],
            xBC[..., DI + N:], conv_state)


def apply_ssm(p, x: torch.Tensor, cfg: ModelConfig, *,
              cache: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """Mamba2 block. x: [B, S, D].  With ``cache`` (decode): S == 1, the
    one-step recurrence.  Returns (out, the cache after the block:
    ``{"ssm_state", "conv"}``)."""
    B, S, D = x.shape
    dt_f = x.dtype
    z, xin, dt, A, Bm, Cm, conv_state = scan_inputs(
        p, x, cfg, None if cache is None else cache["conv"])

    if cache is None:
        # dt and A split with the heads, Bm and Cm shared by them; the
        # state [B, H, P, N]
        y, st = on_local_heads(
            lambda *a: _ssd_chunked(*a, cfg.ssm_chunk),
            (xin, dt.to(dt_f), A, Bm, Cm),
            ((0, 2), (0, 2), (None, 0), (0, None), (0, None)),
            (((0, 2), xin.shape),
             ((0, 1), xin.shape[:1] + xin.shape[2:] + Bm.shape[-1:])),
            (xin.shape[2],))
    else:
        st = cache["ssm_state"]                            # [B, H, P, N]
        a = torch.exp(dt[:, 0] * A)                        # [B, H]
        dBx = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0].to(dt_f), xin[:, 0],
                           Bm[:, 0])
        st = a[:, :, None, None].to(st.dtype) * st + dBx
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], st)[:, None]

    y = y + xin * p["D_skip"].to(dt_f)[:, None]
    y = y.reshape(B, S, cfg.d_inner)
    y = rms_norm_simple(y * F.silu(z)) * p["norm_scale"].to(dt_f)
    return mm(y, p["w_out"].to(dt_f)), {"ssm_state": st, "conv": conv_state}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "ssm_state": torch.zeros((batch, H, P, N), dtype=dtype, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, cfg.d_inner + 2 * N),
                            dtype=dtype, device=device),
    }
