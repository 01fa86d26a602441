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


CHUNK, SUB = 64, 16      # the sm90 kernel's chunk and sub-chunk lengths
LOG2E = 1.4426950408889634


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to f32, as the kernel does
    where it feeds the tensor cores."""
    return x.to(torch.bfloat16).float()


def _chunk_log2_decay(lw: torch.Tensor) -> torch.Tensor:
    """The inclusive cumulative sums of a chunk's f32 log decays
    ``[B, H, 64, K]``, in log2 units, added in the kernel's order: each half
    of 32 steps from its start, the second half plus the first's total,
    then times log2 e."""
    half = CHUNK // 2
    sums = []
    for h in range(2):
        run = torch.zeros_like(lw[:, :, 0])
        for t in range(half * h, half * h + half):
            run = run + lw[:, :, t]
            sums.append(run)
    first = sums[half - 1]
    P = torch.stack(sums[:half] + [first + x for x in sums[half:]], dim=2)
    return P * LOG2E


def linattn_sm90_reference(r, k, v, logw, u, *, stats=None):
    """The arithmetic of ``csrc/linattn_scan_sm90.cu``, in plain PyTorch,
    for the tests: the same function as :func:`linattn_reference`, computed
    the kernel's way and rounded where the kernel rounds.

    Chunks of 64 steps (steps past S are r = k = v = 0, logw = 0), each
    split into four sub-chunks of 16.  With ``P`` the chunk's inclusive
    cumulative log2 decay (``E``), ``Eex[t] = P[t - 1]`` (0 at t = 0) and
    ``e_j = 16 j + 15`` the last step of sub-chunk j:

    - pairs (t, s) in sub-chunks i > j: bf16 ``r[t] exp2(Eex[t] - P[e_j])``
      times bf16 ``k[s] exp2(P[e_j] - P[s])``, summed over the key axis in
      f32 (a tensor-core product per sub-chunk j);
    - pairs s < t in one sub-chunk: ``r[t] k[s] exp2(Eex[t] - P[s])``
      summed in f32, and ``r[t] u k[t]`` at s = t (CUDA cores);
    - y = bf16(pairs) @ v + bf16(r exp2(Eex)) @ bf16(S), f32 sums;
    - S <- exp2(P[63]) S + (hi + lo)^T v, with hi = bf16(kw) and
      lo = bf16(kw - hi) for kw = k exp2(P[63] - P) in f32.

    Every exponent is <= 0.  If ``stats`` is a dict, ``stats["max_exponent"]``
    is set to the largest exponent formed.  Returns ``(y, state)`` as
    :func:`linattn_reference` does.
    """
    B, H, S, K = r.shape
    dev = r.device
    pad = -S % CHUNK
    rf, kf, vf, lw = (torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
                      for a in (r, k, v, logw))
    uf = u.float()[None, :, None, :]
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=dev)
    tri = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool, device=dev), -1)
    max_exp = -float("inf")
    ys = []
    for c0 in range(0, S + pad, CHUNK):
        rc, kc, vc = (a[:, :, c0:c0 + CHUNK] for a in (rf, kf, vf))
        P = _chunk_log2_decay(lw[:, :, c0:c0 + CHUNK])
        X = torch.cat([torch.zeros_like(P[:, :, :1]), P[:, :, :-1]], dim=2)
        A = torch.zeros((B, H, CHUNK, CHUNK), dtype=torch.float32, device=dev)
        for j in range(CHUNK // SUB - 1):
            e = P[:, :, SUB * j + SUB - 1, None]          # [B, H, 1, K]
            rows, cols = slice(SUB * (j + 1), CHUNK), slice(SUB * j, SUB * j + SUB)
            xr, xk = X[:, :, rows] - e, e - P[:, :, cols]
            max_exp = max(max_exp, float(xr.max()), float(xk.max()))
            rj = _bf16(rc[:, :, rows] * torch.exp2(xr))
            kj = _bf16(kc[:, :, cols] * torch.exp2(xk))
            A[:, :, rows, cols] = rj @ kj.transpose(-1, -2)
        for i in range(CHUNK // SUB):
            blk = slice(SUB * i, SUB * i + SUB)
            seg = X[:, :, blk, None, :] - P[:, :, None, blk, :]   # [t, s, K]
            max_exp = max(max_exp, float(seg[:, :, tri].max()))
            w = torch.where(tri[:, :, None], torch.exp2(torch.where(
                tri[:, :, None], seg, torch.zeros_like(seg))), 0.0)
            pair = (rc[:, :, blk, None, :] * kc[:, :, None, blk, :] * w).sum(-1)
            bonus = (rc[:, :, blk] * uf * kc[:, :, blk]).sum(-1)
            A[:, :, blk, blk] = pair + torch.diag_embed(bonus)
        max_exp = max(max_exp, float(X.max()))
        rdec = _bf16(rc * torch.exp2(X))
        y = _bf16(A) @ vc + rdec @ _bf16(state)
        last = P[:, :, -1:]                                # [B, H, 1, K]
        max_exp = max(max_exp, float(last.max()), float((last - P).max()))
        kw = kc * torch.exp2(last - P)
        hi = _bf16(kw)
        lo = _bf16(kw - hi)
        state = (torch.exp2(last[:, :, 0, :, None]) * state
                 + hi.transpose(-1, -2) @ vc + lo.transpose(-1, -2) @ vc)
        ys.append(y)
    if stats is not None:
        stats["max_exponent"] = max_exp
    y = torch.cat(ys, dim=2)[:, :, :S]
    return y.to(r.dtype), state


def sm90_statement_errs(got, want):
    """The sm90 kernel's ``(y, state)`` against
    :func:`linattn_sm90_reference`'s on the same inputs: y's largest error
    beyond one bf16 ulp of the statement's entry, over y's largest entry;
    y's RMS error over y's RMS; the state's largest error over its largest
    entry."""
    y, s = got[0].float(), got[1]
    wy, ws = want[0].float().to(y.device), want[1].to(y.device)
    ulp = torch.where(wy == 0, torch.zeros_like(wy), torch.ldexp(
        torch.ones_like(wy), torch.frexp(wy).exponent - 8))
    d = (y - wy).abs()
    return (float((d - ulp).clamp(min=0).max() / wy.abs().max()),
            float(d.square().mean().sqrt() / wy.square().mean().sqrt()),
            float((s - ws).abs().max() / ws.abs().max()))
