"""RWKV6 "Finch" block: data-dependent per-channel decay linear attention.

Counterpart of ``repro.models.rwkv``.  Time-mix recurrence per head (key
dim K == value dim V == 64, whatever ``cfg.head_dim`` says):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)

with w_t in (0,1) from a low-rank data-dependent projection.  The full
sequence takes the chunked closed form (f32, log-space decays): the
``linattn_scan`` CUDA kernel when ``cfg.use_pallas`` is set, the plain
``wkv_chunked`` otherwise; decode takes the one-token recurrence
``wkv_step``.  Channel-mix is the squared-relu FFN.

Unlike the JAX package, the full-sequence path of both mixes returns the
cache it leaves behind (the final WKV state and the last input position of
each token shift): the port's prefill hands it to decode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.linattn_scan.ops import linattn
from repro_torch.models.layers import rms_norm_simple
from repro_torch.sharding.rules import ParamDef

LORA_R = 64
HEAD = 64     # head width of the recurrence (the JAX package's hd = 64)


def rwkv_defs(cfg: ModelConfig, layers: tuple[int, ...] = ()):
    D = cfg.d_model
    F_ = cfg.d_ff
    lx = ("layers",) * len(layers)
    tm = {
        # token-shift mixing coefficients for r/k/v/g/w
        "mu": ParamDef(layers + (5, D), lx + (None, None), init="zeros"),
        "wr": ParamDef(layers + (D, D), lx + ("embed_fsdp", "heads")),
        "wk": ParamDef(layers + (D, D), lx + ("embed_fsdp", "heads")),
        "wv": ParamDef(layers + (D, D), lx + ("embed_fsdp", "heads")),
        "wg": ParamDef(layers + (D, D), lx + ("embed_fsdp", "heads")),
        "wo": ParamDef(layers + (D, D), lx + ("heads", "embed_fsdp")),
        # data-dependent decay (low-rank) + base
        "w0": ParamDef(layers + (D,), lx + (None,), init="zeros"),
        "wa": ParamDef(layers + (D, LORA_R), lx + ("embed_fsdp", None)),
        "wb": ParamDef(layers + (LORA_R, D), lx + (None, "heads")),
        "u": ParamDef(layers + (D,), lx + (None,), init="zeros"),
        "ln_scale": ParamDef(layers + (D,), lx + (None,), init="ones"),
    }
    cm = {
        "mu": ParamDef(layers + (2, D), lx + (None, None), init="zeros"),
        "wk": ParamDef(layers + (D, F_), lx + ("embed_fsdp", "mlp")),
        "wv": ParamDef(layers + (F_, D), lx + ("mlp", "embed_fsdp")),
        "wr": ParamDef(layers + (D, D), lx + ("embed_fsdp", None)),
    }
    return {"time_mix": tm, "channel_mix": cm}


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]):
    """Shifted sequence: z_t = x_{t-1} (x_prev seeds t=0). Returns (z, last)."""
    if x.shape[1] == 1 and x_prev is not None:
        return x_prev[:, None, :], x[:, 0]
    first = (torch.zeros_like(x[:, :1]) if x_prev is None
             else x_prev[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1), x[:, -1]


def _mix(x, z, mu):
    return x + (z - x) * mu[None, None, :]


def wkv_chunked(r, k, v, logw, u, chunk: int):
    """Chunked WKV, plain PyTorch. r/k/v/logw: [B, S, H, K]; u: [H, K].

    Returns y [B, S, H, K] in r's dtype and the final state [B, H, K, K]
    in f32 (key dim first).
    """
    B, S, H, K = r.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    uf = u.float()
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                      diagonal=-1)                       # strictly past
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    ys = []
    for c0 in range(0, S + pad, Q):
        rq, kq, vq, lwq = (a[:, c0:c0 + Q].float() for a in (r, k, v, logw))
        E = torch.cumsum(lwq, dim=1)                     # inclusive log-decay
        Eex = E - lwq                                    # exclusive (through t-1)
        # intra-chunk pairwise decays in log space (exponent <= 0 for t > s)
        seg = Eex[:, :, None] - E[:, None]               # [B, Q, Q, H, K]
        seg = torch.where(mask[None, :, :, None, None], seg, -torch.inf)
        att = torch.einsum("bqhk,bshk,bqshk->bhqs", rq, kq, torch.exp(seg))
        r_dec = rq * torch.exp(Eex)                      # Eex <= 0: stable
        diag = torch.einsum("bqhk,hk,bqhk->bqh", rq, uf, kq)
        y = torch.einsum("bhqs,bshk->bqhk", att, vq)
        y = y + diag[..., None] * vq
        y = y + torch.einsum("bqhk,bhkv->bqhv", r_dec, state)
        # state' = diag(prod w) state + sum_s (prod_{>s} w) k_s v_s^T
        Eq = E[:, -1]                                    # [B, H, K]
        kw = kq * torch.exp(Eq[:, None] - E)
        state = torch.exp(Eq)[..., None] * state + torch.einsum(
            "bshk,bshv->bhkv", kw, vq)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(r.dtype), state


def wkv_step(r, k, v, logw, u, state):
    """One-token recurrence. r/k/v/logw: [B, H, K]; state [B, H, K, K]."""
    rf, kf, vf = (a.float() for a in (r, k, v))
    w = torch.exp(logw.float())
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rf,
                     state + u.float()[None, :, :, None] * kv)
    state = w[..., None] * state + kv
    return y.to(r.dtype), state


def apply_time_mix(
    p, x: torch.Tensor, cfg: ModelConfig,
    *, cache: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    """Time-mix of ``x`` [B, S, D].  Returns (out, cache): the new
    ``{"wkv", "shift_att"}`` after a decode step (``cache`` given, S = 1),
    or the one the whole sequence leaves (``cache`` None)."""
    B, S, D = x.shape
    H = D // HEAD
    dt = x.dtype
    z, last = _token_shift(x, None if cache is None else cache["shift_att"])
    mu = p["mu"].to(dt)
    xr, xk, xv, xg, xw = (_mix(x, z, mu[i]) for i in range(5))
    r = (xr @ p["wr"].to(dt)).reshape(B, S, H, HEAD)
    k = (xk @ p["wk"].to(dt)).reshape(B, S, H, HEAD)
    v = (xv @ p["wv"].to(dt)).reshape(B, S, H, HEAD)
    g = xg @ p["wg"].to(dt)
    lora = torch.tanh(xw.float()) @ p["wa"].float() @ p["wb"].float()
    logw = -torch.exp(p["w0"].float()[None, None] + lora)   # < 0
    logw = logw.reshape(B, S, H, HEAD)
    u = p["u"].float().reshape(H, HEAD)

    if cache is not None:
        y, state = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u,
                            cache["wkv"])
        y = y[:, None]
    elif cfg.use_pallas:
        # [B, H, S, K] views of the [B, S, H, K] tensors: the kernel reads
        # them in place and writes y in r's layout, so y's view is contiguous
        y, state = linattn(*(a.transpose(1, 2) for a in (r, k, v, logw)), u,
                           chunk=cfg.rwkv_chunk, return_state=True)
        y = y.transpose(1, 2)
    else:
        y, state = wkv_chunked(r, k, v, logw, u, cfg.rwkv_chunk)

    y = rms_norm_simple(y.reshape(B, S, D)) * p["ln_scale"].to(dt)
    y = y * F.silu(g)
    return y @ p["wo"].to(dt), {"wkv": state, "shift_att": last}


def apply_channel_mix(
    p, x: torch.Tensor, cfg: ModelConfig,
    *, cache: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    """Channel-mix of ``x`` [B, S, D].  Returns (out, {"shift_ffn": last
    input position}), with or without a cache."""
    dt = x.dtype
    z, last = _token_shift(x, None if cache is None else cache["shift_ffn"])
    mu = p["mu"].to(dt)
    xk, xr = _mix(x, z, mu[0]), _mix(x, z, mu[1])
    k = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    kv = k @ p["wv"].to(dt)
    r = torch.sigmoid(xr @ p["wr"].to(dt))
    return r * kv, {"shift_ffn": last}


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype) -> dict:
    D = cfg.d_model
    H = D // HEAD
    return {
        "wkv": torch.zeros((batch, H, HEAD, HEAD), dtype=torch.float32),
        "shift_att": torch.zeros((batch, D), dtype=dtype),
        "shift_ffn": torch.zeros((batch, D), dtype=dtype),
    }
