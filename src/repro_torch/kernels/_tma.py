"""The tensors that the port's sm90 kernels read by TMA.

A 4-D TMA map needs a contiguous innermost dim, a 16-byte aligned base
address and strides of a multiple of 16 bytes; :func:`tma_view` checks a
tensor against that and returns the strides the kernels encode.
"""

from __future__ import annotations

import torch


def tma_view(x: torch.Tensor, name: str):
    """``x``, a 4-D tensor, as a sm90 kernel's TMA reads it, and the
    element strides of its first three dims.  The last dim must be
    contiguous (else ``x`` is copied so); the base address must be 16-byte
    aligned and every stride a multiple of 16 bytes, else this raises.  A dim of size 1 is never
    stepped, so its stride is taken as the extent of the dims inside it."""
    if x.stride(-1) != 1:
        x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: TMA needs a 16-byte aligned base address, "
                         f"got {x.data_ptr():#x}")
    strides, inner = [], x.shape[3]
    for d in (2, 1, 0):
        st = x.stride(d) if x.shape[d] > 1 else inner
        if st * x.element_size() % 16:
            raise ValueError(
                f"{name}: TMA needs strides of a multiple of 16 bytes; dim {d} "
                f"of {tuple(x.shape)} steps {st * x.element_size()} bytes")
        strides.append(st)
        inner = st * x.shape[d]
    return x, strides[::-1]
