"""``flash_attention``: dispatch between the Hopper kernel and its plain
version.

A CPU tensor takes the plain PyTorch version (``ref.py``).  A CUDA tensor
launches the CUDA kernel of ``csrc/flash_attention.cu`` or raises; nothing
falls back.  ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_reference

SOURCE = "flash_attention/csrc/flash_attention.cu"
HEAD_DIMS = (32, 64, 80, 128)            # the kernel's instantiations
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SOURCE)))
    lib.flash_attention_launch.argtypes = [
        ctypes.c_void_p,    # q, [B, Sq, H, hd]
        ctypes.c_void_p,    # k, [B, Sk, KV, hd]
        ctypes.c_void_p,    # v, [B, Sk, KV, hd]
        ctypes.c_void_p,    # out, [B, Sq, H, hd]
        ctypes.c_int,       # dtype: 0 = f32, 1 = bf16
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
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of f32 or bf16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    # every query row must see at least one key: the kernel skips whole
    # key tiles that hold none, where the reference would average them all
    if causal and q_offset < 0:
        raise ValueError(f"causal attention needs q_offset >= 0, got {q_offset}")
    if window is not None and q_offset + Sq - window > Sk - 1:
        raise ValueError(f"the last query row (position {q_offset + Sq - 1}) "
                         f"sees no key of {Sk} through a window of {window}")


def _contiguous(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows as 16-byte vectors."""
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("flash_attention needs 16-byte aligned tensors")
    return x


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
    the kernel picks its own tiles."""
    del block_q, block_k
    _check(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    q, k, v = _contiguous(q), _contiguous(k), _contiguous(v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], B, Sq, Sk, H, KV, hd, int(causal),
        0 if window is None else int(window), int(q_offset),
        hd ** -0.5 * math.log2(math.e), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
