"""``flash_attention``: dispatch between the Hopper kernels and their plain
version.

A CPU tensor takes the plain PyTorch version (``ref.py``).  A CUDA tensor
launches a CUDA kernel or raises; nothing falls back.  The route is fixed by
the dtype:

- bf16 (the serve path) goes to ``csrc/flash_attention_sm90.cu``, on the
  tensor cores (wgmma fed by a TMA ring of K/V tiles);
- f32 (the checks' path: the f32 grid, the LM golden and full-width checks)
  goes to ``csrc/flash_attention.cu``, f32 FMAs on the CUDA cores, whose
  tolerances bf16 or TF32 tensor cores cannot meet.

``flash_attention.launches`` counts kernel launches and
``flash_attention.launches_by_route`` counts them by route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tma import tma_view as _tma_view
from repro_torch.kernels.flash_attention.ref import attention_reference

SOURCE = "flash_attention/csrc/flash_attention.cu"
SM90_SOURCE = "flash_attention/csrc/flash_attention_sm90.cu"
HEAD_DIMS = (32, 64, 80, 128)            # both kernels' instantiations
ROUTES = {torch.bfloat16: "sm90_bf16", torch.float32: "f32"}
BLOCK_Q = BLOCK_K = 128                  # the sm90 kernel's tiles
_ERR_NO_ENCODER, _ERR_ENCODE = 900, 1000  # flash_attention_sm90.cu's codes


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SOURCE)))
    lib.flash_attention_launch.argtypes = [
        ctypes.c_void_p,    # q, [B, Sq, H, hd]
        ctypes.c_void_p,    # k, [B, Sk, KV, hd]
        ctypes.c_void_p,    # v, [B, Sk, KV, hd]
        ctypes.c_void_p,    # out, [B, Sq, H, hd]
        ctypes.c_int,       # dtype: 0 = f32, the only one routed here
        ctypes.c_int, ctypes.c_int, ctypes.c_int,   # B, Sq, Sk
        ctypes.c_int, ctypes.c_int, ctypes.c_int,   # H, KV, hd
        ctypes.c_int,       # causal
        ctypes.c_int,       # window (0 = none)
        ctypes.c_longlong,  # q_offset
        ctypes.c_float,     # hd ** -0.5 * log2(e)
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm90_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SM90_SOURCE)))
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_attention_sm90_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p,                                      # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,             # B, Sq, Sk
        ctypes.c_int, ctypes.c_int, ctypes.c_int,             # H, KV, hd
        strides, strides, strides,   # (batch, seq, head) strides of q, k, v
        ctypes.c_int,       # causal
        ctypes.c_int,       # window (0 = none)
        ctypes.c_longlong,  # q_offset
        ctypes.c_float,     # hd ** -0.5 * log2(e)
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.flash_attention_sm90_launch.restype = ctypes.c_int
    lib.flash_attention_sm90_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_attention_sm90_smem_bytes.restype = ctypes.c_int
    return lib


def sm90_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one CTA of the sm90 kernel at head dim
    ``hd``, as the kernel requests it (builds the kernel if needed)."""
    return _sm90_lib().flash_attention_sm90_smem_bytes(hd)


def _check_rows_see_keys(Sq: int, Sk: int, causal: bool,
                         window: Optional[int], q_offset: int) -> None:
    """Every query row must see at least one key: the kernels skip whole key
    tiles that hold none, where the reference would average them all."""
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if causal and q_offset < 0:
        raise ValueError(f"causal attention needs q_offset >= 0, got {q_offset}")
    if window is not None and q_offset + Sq - window > Sk - 1:
        raise ValueError(f"the last query row (position {q_offset + Sq - 1}) "
                         f"sees no key of {Sk} through a window of {window}")


def _check(q, k, v, causal, window, q_offset) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B, Sq, H, hd] and k, v one shape [B, Sk, KV, hd]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KV, hdk = k.shape
    if k.shape[0] != B or hdk != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head_dim")
    if Sq < 1 or Sk < 1 or KV < 1 or H % KV:
        raise ValueError(f"need Sq, Sk >= 1 and H % KV == 0; got Sq={Sq}, "
                         f"Sk={Sk}, H={H}, KV={KV}")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of f32 or bf16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    _check_rows_see_keys(Sq, Sk, causal, window, q_offset)


def _kv_tile_plan(Sq: int, Sk: int, q_offset: int, causal: bool,
                  window: Optional[int], block_q: int = BLOCK_Q,
                  block_k: int = BLOCK_K) -> list:
    """The sm90 kernel's tile schedule, one entry per query tile of
    ``block_q`` rows: ``(lo, hi, masked)``, where the tile visits KV tiles
    ``lo .. hi - 1`` of ``block_k`` keys and ``masked[t - lo]`` says whether
    tile ``t`` takes the -1e30 mask (it crosses the causal diagonal, the
    window's edge or ``Sk``) or the unmasked path (every key visible to
    every live row, those below ``Sq``).  ``flash_attention_sm90.cu``
    computes the same in its prologue and loop."""
    plan = []
    for q0 in range(0, Sq, block_q):
        first = q_offset + q0
        last = q_offset + min(q0 + block_q, Sq) - 1
        k_end = min(Sk, last + 1) if causal else Sk
        k_begin = max(0, first - window + 1) if window is not None else 0
        lo = k_begin // block_k
        hi = -(-k_end // block_k) if k_end > k_begin else lo
        masked = [k0 + block_k > Sk
                  or (causal and k0 + block_k - 1 > first)
                  or (window is not None and last - k0 >= window)
                  for k0 in range(lo * block_k, hi * block_k, block_k)]
        plan.append((lo, hi, masked))
    return plan


def _launch_sm90(q, k, v, causal, window, q_offset) -> torch.Tensor:
    (q, qs), (k, ks), (v, vs) = (_tma_view(x, n) for x, n in
                                 ((q, "q"), (k, "k"), (v, "v")))
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    arr = ctypes.c_longlong * 3
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _sm90_lib().flash_attention_sm90_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, hd, arr(*qs), arr(*ks), arr(*vs), int(causal),
        0 if window is None else int(window), int(q_offset),
        hd ** -0.5 * math.log2(math.e), stream)
    if err == _ERR_NO_ENCODER:
        raise RuntimeError("flash_attention sm90 kernel: the CUDA driver "
                           "offers no cuTensorMapEncodeTiled")
    if err >= _ERR_ENCODE:
        raise RuntimeError(f"flash_attention sm90 kernel: the driver refused "
                           f"a TMA map (CUresult {err - _ERR_ENCODE})")
    if err != 0:
        raise RuntimeError(
            f"flash_attention sm90 kernel launch failed: CUDA error {err}")
    return out


def _launch_f32(q, k, v, causal, window, q_offset) -> torch.Tensor:
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned tensors")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0,
        B, Sq, Sk, H, KV, hd, int(causal),
        0 if window is None else int(window), int(q_offset),
        hd ** -0.5 * math.log2(math.e), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    return out


def flash_attention(
    q: torch.Tensor,   # [B, Sq, H, hd]
    k: torch.Tensor,   # [B, Sk, KV, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """GQA attention forward, ``[B, Sq, H, hd]`` in q's dtype.

    ``block_q``/``block_k`` are accepted for the JAX wrapper's signature;
    the kernels pick their own tiles."""
    del block_q, block_k
    _check(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    route = ROUTES[q.dtype]
    launch = _launch_sm90 if route == "sm90_bf16" else _launch_f32
    out = launch(q, k, v, causal, window, q_offset)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


def reset_launches() -> None:
    """Set the launch count and the count of every route to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(ROUTES.values(), 0)


reset_launches()
