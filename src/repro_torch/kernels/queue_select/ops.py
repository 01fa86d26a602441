"""``queue_select``: dispatch between the Hopper kernel and its plain version.

A CPU tensor takes the plain PyTorch version (``ref.py``).  A CUDA tensor
launches the CUDA kernel of ``csrc/queue_select.cu`` or raises; nothing
falls back.  ``queue_select.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.queue_select.ref import queue_select_reference

SOURCE = "queue_select/csrc/queue_select.cu"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SOURCE)))
    lib.queue_select_launch.argtypes = [
        ctypes.c_void_p,   # scores, int32[n]
        ctypes.c_void_p,   # feasible, bool or int32 [n]
        ctypes.c_int,      # bytes per mask entry (1 or 4)
        ctypes.c_longlong,  # n
        ctypes.c_void_p,   # scratch, one uint64 word
        ctypes.c_void_p,   # out, int32[2]
        ctypes.c_void_p,   # cudaStream_t
    ]
    lib.queue_select_launch.restype = ctypes.c_int
    return lib


def _check(scores: torch.Tensor, feasible: torch.Tensor) -> None:
    if scores.dtype != torch.int32:
        raise TypeError(f"scores must be int32, got {scores.dtype}")
    if feasible.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"feasible must be bool or int32, got {feasible.dtype}")
    if scores.dim() != 1 or feasible.shape != scores.shape:
        raise ValueError(
            f"scores and feasible must be 1-D of one length, got "
            f"{tuple(scores.shape)} and {tuple(feasible.shape)}")
    if scores.numel() == 0:
        raise ValueError("queue_select needs at least one entry")
    if scores.device != feasible.device:
        raise ValueError(
            f"scores on {scores.device} but feasible on {feasible.device}")


def queue_select(scores: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """Masked lex-argmin: i32[2] = (index or -1, best score or BIG)."""
    _check(scores, feasible)
    if scores.device.type == "cpu":
        return queue_select_reference(scores, feasible)
    if scores.device.type != "cuda":
        raise ValueError(f"queue_select runs on cpu or cuda, not {scores.device}")
    if not (scores.is_contiguous() and feasible.is_contiguous()):
        raise ValueError("queue_select needs contiguous tensors")
    # out[0:2] is the answer; out[2:4] is the kernel's 8-byte scratch word
    buf = torch.empty(4, dtype=torch.int32, device=scores.device)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    err = _lib().queue_select_launch(
        scores.data_ptr(), feasible.data_ptr(), feasible.element_size(),
        scores.numel(), buf.data_ptr() + 8, buf.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"queue_select kernel launch failed: CUDA error {err}")
    queue_select.launches += 1
    return buf[:2]


queue_select.launches = 0
