"""``linattn``: dispatch between the Hopper kernels and their plain version.

A CPU tensor takes the plain PyTorch version (``ref.py``), whatever the
dtype.  A CUDA tensor launches a CUDA kernel or raises; nothing falls
back.  The route is fixed by r's dtype and the key dim K, by
:func:`route`:

- bf16 r/k/v with K 64 or 128 (the rwkv serve path) goes to
  ``csrc/linattn_scan_sm90.cu``, on the tensor cores (wgmma, chunks of 64
  steps fed by TMA);
- everything else (f32, the checks' path, and bf16 with K 16 or 32) goes to
  ``csrc/linattn_scan.cu``, f32 FMAs on the CUDA cores.

``linattn.launches`` counts kernel launches (one a call) and
``linattn.launches_by_route`` counts them by route; ``reset_launches()``
zeroes both.

Both kernels read r, k, v and logw through their strides, so a
``[B, H, S, K]`` view of the model's ``[B, S, H, K]`` activations
(``x.transpose(1, 2)``) is read in place, without a copy; y comes back in
r's layout (``torch.empty_like``), so the same view of it is contiguous
again.  The key axis must be contiguous; a tensor whose key axis is not is
copied first.  The sm90 kernel reads by TMA, which also needs 16-byte
aligned bases and strides (``_tma.tma_view`` raises otherwise).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tma import tma_view
from repro_torch.kernels.linattn_scan.ref import linattn_reference

SOURCE = "linattn_scan/csrc/linattn_scan.cu"
SM90_SOURCE = "linattn_scan/csrc/linattn_scan_sm90.cu"
KEY_DIMS = (16, 32, 64, 128)             # the CUDA-core kernel's instantiations
SM90_KEY_DIMS = (64, 128)                # the sm90 kernel's
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("sm90_bf16", "cuda_core")
_ERR_NO_ENCODER, _ERR_ENCODE = 900, 1000  # linattn_scan_sm90.cu's codes


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(SOURCE)))
    lib.linattn_scan_launch.argtypes = [
        ctypes.c_void_p,    # r, [B, H, S, K]
        ctypes.c_void_p,    # k
        ctypes.c_void_p,    # v
        ctypes.c_void_p,    # logw
        ctypes.c_void_p,    # u, [H, K] f32
        ctypes.c_void_p,    # y, [B, H, S, K]
        ctypes.c_void_p,    # state, [B, H, K, K] f32
        ctypes.c_int,       # dtype of r, k, v, y: 0 = f32, 1 = bf16
        ctypes.c_int,       # dtype of logw
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, S, K
        ctypes.c_void_p,    # 15 int64 strides: (batch, head, time) x 5
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.linattn_scan_launch.restype = ctypes.c_int
    return lib


def _bind_sm90(path) -> ctypes.CDLL:
    """Load a build of ``linattn_scan_sm90.cu`` and declare its C entry
    points."""
    lib = ctypes.CDLL(str(path))
    lib.linattn_scan_sm90_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # r, k, v bf16
        ctypes.c_void_p,    # logw
        ctypes.c_void_p,    # u, [H, K] f32
        ctypes.c_void_p,    # y, [B, H, S, K] bf16
        ctypes.c_void_p,    # state, [B, H, K, K] f32
        ctypes.c_int,       # dtype of logw: 0 = f32, 1 = bf16
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, S, K
        ctypes.c_void_p,    # 15 int64 strides: (batch, head, time) x 5
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.linattn_scan_sm90_launch.restype = ctypes.c_int
    lib.linattn_scan_sm90_smem_bytes.argtypes = [ctypes.c_int]
    lib.linattn_scan_sm90_smem_bytes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm90_lib() -> ctypes.CDLL:
    return _bind_sm90(_build.build(SM90_SOURCE))


def sm90_smem_bytes(K: int) -> int:
    """Dynamic shared memory of one CTA of the sm90 kernel at key dim
    ``K``, as the kernel requests it (builds the kernel if needed)."""
    return _sm90_lib().linattn_scan_sm90_smem_bytes(K)


def route(dtype: torch.dtype, K: int) -> str:
    """The kernel a CUDA call of r's ``dtype`` and key dim ``K`` launches."""
    return "sm90_bf16" if dtype == torch.bfloat16 and K in SM90_KEY_DIMS \
        else "cuda_core"


def _check(r, k, v, logw, u) -> None:
    if r.dim() != 4 or not (k.shape == v.shape == logw.shape == r.shape):
        raise ValueError(
            f"r, k, v, logw must share one shape [B, H, S, K]; got "
            f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(logw.shape)}")
    B, H, S, K = r.shape
    if B < 1 or H < 1 or S < 1:
        raise ValueError(f"need B, H, S >= 1; got {tuple(r.shape)}")
    if K not in KEY_DIMS:
        raise ValueError(f"key dim {K} not in {KEY_DIMS}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u must be [H, K] = {(H, K)}, got {tuple(u.shape)}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share one dtype of f32 or bf16; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype not in DTYPES:
        raise TypeError(f"logw must be f32 or bf16, got {logw.dtype}")
    if u.dtype != torch.float32:
        raise TypeError(f"u must be f32, got {u.dtype}")
    devices = {t.device for t in (r, k, v, logw, u)}
    if len(devices) != 1:
        raise ValueError(f"r, k, v, logw, u on {sorted(map(str, devices))}")


def _key_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _launch_cuda_core(r, k, v, logw, u, y, state) -> None:
    B, H, S, K = r.shape
    strides = (ctypes.c_longlong * 15)(
        *(s for x in (r, k, v, logw, y) for s in x.stride()[:3]))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _lib().linattn_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), DTYPES[r.dtype],
        DTYPES[logw.dtype], B, H, S, K, ctypes.addressof(strides), stream)
    if err != 0:
        raise RuntimeError(f"linattn_scan kernel launch failed: CUDA error {err}")


def _launch_sm90(r, k, v, logw, u, y, state) -> None:
    views = [tma_view(x, n) for x, n in ((r, "r"), (k, "k"), (v, "v"),
                                         (logw, "logw"))]
    (r, rs), (k, ks), (v, vs), (logw, ws) = views
    B, H, S, K = r.shape
    strides = (ctypes.c_longlong * 15)(*rs, *ks, *vs, *ws, *y.stride()[:3])
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _sm90_lib().linattn_scan_sm90_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), DTYPES[logw.dtype],
        B, H, S, K, ctypes.addressof(strides), stream)
    if err == _ERR_NO_ENCODER:
        raise RuntimeError("linattn_scan sm90 kernel: the CUDA driver offers "
                           "no cuTensorMapEncodeTiled")
    if err >= _ERR_ENCODE:
        raise RuntimeError(f"linattn_scan sm90 kernel: the driver refused a "
                           f"TMA map (CUresult {err - _ERR_ENCODE})")
    if err != 0:
        raise RuntimeError(
            f"linattn_scan sm90 kernel launch failed: CUDA error {err}")


def linattn(r, k, v, logw, u, *, chunk: int = 128, return_state: bool = False):
    """Chunked RWKV6 linear attention on ``[B, H, S, K]`` inputs.

    r, k, v: f32 or bf16, one dtype; logw: f32 or bf16 (< 0); u: f32
    ``[H, K]``.  Returns y ``[B, H, S, K]`` in r's dtype or, with
    ``return_state``, ``(y, state)`` where state is the final f32
    ``[B, H, K, K]``, key axis first.  ``chunk`` is accepted for the JAX
    wrapper's signature; the kernels pick their own chunk, which changes the
    result only by rounding.  Forward only: with grad mode on and an input
    that requires grad it raises, on every device.
    """
    del chunk
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, logw, u)):
        raise RuntimeError(
            "linattn has no backward pass (the reference cannot "
            "differentiate its Pallas kernel either): train with "
            "use_pallas=False, which takes wkv_chunked")
    _check(r, k, v, logw, u)
    if r.device.type == "cpu":
        y, state = linattn_reference(r, k, v, logw, u)
        return (y, state) if return_state else y
    if r.device.type != "cuda":
        raise ValueError(f"linattn runs on cpu or cuda, not {r.device}")
    r, k, v, logw = (_key_contiguous(x) for x in (r, k, v, logw))
    u = u.contiguous()
    B, H, S, K = r.shape
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    path = route(r.dtype, K)
    launch = _launch_sm90 if path == "sm90_bf16" else _launch_cuda_core
    launch(r, k, v, logw, u, y, state)
    linattn.launches += 1
    linattn.launches_by_route[path] += 1
    return (y, state) if return_state else y


def reset_launches() -> None:
    """Set the launch count and the count of every route to 0."""
    linattn.launches = 0
    linattn.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launches()
