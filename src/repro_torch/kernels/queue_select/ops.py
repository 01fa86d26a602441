"""``queue_select``: dispatch between the Hopper kernels and their plain
versions.

A CPU tensor takes the plain PyTorch version (``ref.py``).  A CUDA tensor
launches a kernel of ``csrc/queue_select.cu`` or raises; nothing falls
back.  Two ways in:

- :func:`queue_select` (scores, mask) -> device i32[2], the TPU kernel's
  function;
- :class:`TableSelect`, bound to one job table: :meth:`TableSelect.select`
  builds the key and the mask of a mode (``ref.MODES``) in the kernel and
  returns ``(index, score)`` as Python ints;
- :func:`shadow_walk` (a ``TableSelect``, the state) runs the EASY shadow
  walk in one launch;
- :class:`BatchedTableSelect`, bound to a stacked ``[B, J]`` table (an
  ensemble's): :meth:`~BatchedTableSelect.select_batch` and
  :meth:`~BatchedTableSelect.walk_batch` answer one request for each of
  several members in one launch.

On CUDA all but the generic op wait for their stream once and read the
answer from mapped host memory.

The table's ``nodes`` column is the rigid node requests.  A run whose jobs
change width under the selector (malleable jobs) passes its width column
with each call (``nodes=``, a tensor like the bound column): the call reads
it in place of the bound one, and a call without it reads the bound column
again.

``queue_select.launches`` counts the launches of the solo select kernels
(any mode, and the generic op); ``shadow_walk.launches`` those of the walk,
and ``shadow_walk.steps`` the releases its launches counted.  The batched
launches count apart: ``queue_select.batch_launches`` and
``queue_select.batch_selections`` (the member-selections they served),
``shadow_walk.batch_launches``, ``shadow_walk.batch_walks`` and
``shadow_walk.batch_steps``.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.queue_select.ref import (
    MODES, PARAMS, fused_select_batched_reference, fused_select_reference,
    queue_select_reference, shadow_walk_batched_reference,
    shadow_walk_reference,
)

SOURCE = "queue_select/csrc/queue_select.cu"
COLUMNS = ("submit", "estimate", "nodes", "priority")


class _SelectArgs(ctypes.Structure):
    """``SelectArgs`` of ``csrc/queue_select.cu``."""
    _fields_ = [(c, ctypes.c_void_p) for c in COLUMNS] + [
        ("jstate", ctypes.c_void_p), ("rsv_finish", ctypes.c_void_p),
        ("n", ctypes.c_longlong)] + [
        (f, ctypes.c_int32) for f in ("mode",) + PARAMS]


# the same layout, packed from Python ints: the six pointers, n, mode and
# the PARAMS, and the padding to the struct's 8-byte alignment
_ARGS_PACK = struct.Struct("<6Qq9i4x")
assert _ARGS_PACK.size == ctypes.sizeof(_SelectArgs) == 96


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(ctypes.CDLL(str(_build.build(SOURCE))))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from ``SOURCE``."""
    lib.queue_select_launch.argtypes = [
        ctypes.c_void_p,   # scores, int32[n]
        ctypes.c_void_p,   # feasible, bool or int32 [n]
        ctypes.c_int,      # bytes per mask entry (1 or 4)
        ctypes.c_longlong,  # n
        ctypes.c_void_p,   # out, int32[2]
        ctypes.c_void_p,   # cudaStream_t
    ]
    for fn in (lib.queue_select_fused, lib.queue_select_walk):
        fn.argtypes = [ctypes.POINTER(_SelectArgs),
                       ctypes.c_void_p,                  # cudaStream_t
                       ctypes.POINTER(ctypes.c_int32)]   # result, on the host
    for fn in (lib.queue_select_fused_batch, lib.queue_select_walk_batch):
        fn.argtypes = [ctypes.c_void_p,     # SelectArgs[n_req], on the host
                       ctypes.c_int,        # n_req
                       ctypes.c_void_p,     # cudaStream_t
                       ctypes.c_void_p]     # result, int32[4 n_req] on the host
    for fn in (lib.queue_select_launch, lib.queue_select_fused,
               lib.queue_select_walk, lib.queue_select_fused_batch,
               lib.queue_select_walk_batch):
        fn.restype = ctypes.c_int
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
    out = torch.empty(2, dtype=torch.int32, device=scores.device)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    err = _lib().queue_select_launch(
        scores.data_ptr(), feasible.data_ptr(), feasible.element_size(),
        scores.numel(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"queue_select kernel launch failed: CUDA error {err}")
    queue_select.launches += 1
    return out


def shadow_walk(table: "TableSelect", jstate: torch.Tensor,
                rsv_finish: torch.Tensor, clock: int, free: int,
                head_need: int,
                nodes: torch.Tensor | None = None) -> tuple[int, int, int]:
    """EASY shadow reservation ``(shadow, extra, k_row)`` over ``table``'s
    running rows, for a head needing ``head_need`` nodes
    (``ref.shadow_walk_reference``): one launch and one wait on CUDA.
    ``nodes`` replaces the table's node column for this call."""
    if not table.on_cuda:
        return shadow_walk_reference(
            table.cols["nodes"] if nodes is None else nodes, jstate,
            rsv_finish, clock, free, head_need)
    a = table._state(jstate, rsv_finish, nodes)
    a.clock, a.free, a.head_need = clock, free, head_need
    err = table._lib.queue_select_walk(table._args_p, table._stream,
                                       table._result)
    if err != 0:
        raise RuntimeError(f"queue_select shadow walk: CUDA error {err}")
    shadow_walk.launches += 1
    r = table._result
    shadow_walk.steps += r[3]
    return r[0], r[1], r[2]


def reset_launches() -> None:
    queue_select.launches = 0
    queue_select.batch_launches = queue_select.batch_selections = 0
    shadow_walk.launches = shadow_walk.steps = 0
    shadow_walk.batch_launches = shadow_walk.batch_walks = 0
    shadow_walk.batch_steps = 0


reset_launches()


class TableSelect:
    """The fused selections over one job table (and :func:`shadow_walk`'s).

    ``columns`` maps ``submit``, ``estimate``, ``nodes`` and ``priority`` to
    int32 tensors of one length on one device.  The per-call arguments are
    the job states (and, for the walk, the reservations) and host ints.  On
    a CUDA device each call launches one kernel on the stream bound by
    :meth:`bind_stream` (the current stream when the table was made), waits
    for it, and returns Python ints.
    """

    def __init__(self, columns: dict):
        cols = {c: columns[c] for c in COLUMNS}
        first = cols["submit"]
        for c, t in cols.items():
            if (t.dtype != torch.int32 or t.dim() != 1
                    or t.shape != first.shape or t.device != first.device
                    or not t.is_contiguous()):
                raise ValueError(
                    f"column {c} must be a contiguous int32 vector like "
                    f"submit ({first.dtype}, {tuple(first.shape)}, "
                    f"{first.device}); got {t.dtype}, {tuple(t.shape)}, "
                    f"{t.device}")
        self.cols = cols
        self.n = first.numel()
        self.device = first.device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(
                f"TableSelect runs on cpu or cuda, not {self.device}")
        self.on_cuda = self.device.type == "cuda"
        if self.on_cuda:
            self._lib = _lib()
            self._args = _SelectArgs(*(t.data_ptr() for t in cols.values()),
                                     0, 0, self.n)
            self._nodes_ptr = self._args.nodes
            self._args_p = ctypes.pointer(self._args)
            self._result = (ctypes.c_int32 * 4)()
            self.bind_stream()

    def bind_stream(self) -> None:
        """Launch on the device's current stream from now on."""
        if self.on_cuda:
            self._stream = torch.cuda.current_stream(self.device).cuda_stream

    def _state(self, jstate: torch.Tensor, rsv_finish: torch.Tensor | None,
               nodes: torch.Tensor | None = None):
        """The call's arguments: the state columns' pointers, and the node
        column's (the per-call ``nodes``, else the bound one)."""
        a = self._args
        for t in (jstate, rsv_finish, nodes):
            if t is not None and (
                    t.device != self.device or t.dtype != torch.int32
                    or t.numel() != self.n or not t.is_contiguous()):
                raise ValueError(
                    f"state columns must be contiguous int32[{self.n}] on "
                    f"{self.device}, got {t.dtype}[{t.numel()}] on {t.device}")
        a.jstate = jstate.data_ptr()
        a.rsv_finish = (a.jstate if rsv_finish is None
                        else rsv_finish.data_ptr())
        a.nodes = (self._nodes_ptr if nodes is None else nodes.data_ptr())
        return a

    def select(self, mode: int, jstate: torch.Tensor, clock: int = 0,
               free: int = 0, cap: int = 0, shadow: int = 0, extra: int = 0,
               exclude: int = -1, tier: int = 0,
               nodes: torch.Tensor | None = None) -> tuple[int, int]:
        """``(index, score)`` of the masked lexicographic argmin of
        ``mode``'s key and mask (``ref.fused_key_mask``); ``(-1, BIG)``
        when no row is feasible.  ``nodes`` replaces the table's node
        column for this call."""
        if not self.on_cuda:
            cols = self.cols if nodes is None else {**self.cols,
                                                    "nodes": nodes}
            return fused_select_reference(mode, cols, jstate, clock, free,
                                          cap, shadow, extra, exclude, tier)
        a = self._state(jstate, None, nodes)
        a.mode, a.clock, a.free, a.cap = mode, clock, free, cap
        a.shadow, a.extra, a.exclude, a.tier = shadow, extra, exclude, tier
        err = self._lib.queue_select_fused(self._args_p, self._stream,
                                           self._result)
        if err != 0:
            raise RuntimeError(
                f"queue_select fused mode {mode}: CUDA error {err}")
        queue_select.launches += 1
        r = self._result
        return r[0], r[1]


class BatchedTableSelect:
    """The fused selections and the walk over a stacked ``[B, J]`` table,
    several members at once.

    ``columns`` maps ``submit``, ``estimate``, ``nodes`` and ``priority`` to
    contiguous int32 ``[B, J]`` tensors on one device; row ``b`` is member
    ``b``'s table.  A call takes a list of requests, at most one a member,
    and the ``[B, J]`` state; it answers every request, in order, with
    member-local indices.  A select request is ``(member, mode, params)``, a
    walk request ``(member, params)``, where ``params`` holds the scalars of
    ``ref.PARAMS`` in that order.  On CUDA a call is one upload of its
    requests, one launch of the batched kernel (one cluster a request) and
    one wait, whatever the number of requests; on the CPU it takes the
    batched plain version.
    """

    def __init__(self, columns: dict):
        cols = {c: columns[c] for c in COLUMNS}
        first = cols["submit"]
        for c, t in cols.items():
            if (t.dtype != torch.int32 or t.dim() != 2
                    or t.shape != first.shape or t.device != first.device
                    or not t.is_contiguous()):
                raise ValueError(
                    f"column {c} must be a contiguous int32 [B, J] tensor "
                    f"like submit ({first.dtype}, {tuple(first.shape)}, "
                    f"{first.device}); got {t.dtype}, {tuple(t.shape)}, "
                    f"{t.device}")
        self.cols = cols
        self.batch, self.n = first.shape
        self.device = first.device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(
                f"BatchedTableSelect runs on cpu or cuda, not {self.device}")
        if self.n < 1:
            raise ValueError("BatchedTableSelect needs at least one row")
        self.on_cuda = self.device.type == "cuda"
        # member b's column pointers: its row of each [B, J] column
        self._cols_of = [tuple(t.data_ptr() + 4 * self.n * b
                               for t in cols.values())
                         for b in range(self.batch)]
        # one request a member at most: room for B of them, and their answers
        self._args = ctypes.create_string_buffer(self.batch * _ARGS_PACK.size)
        self._answers = (ctypes.c_int32 * (4 * self.batch))()
        if self.on_cuda:
            self._lib = _lib()
            self.bind_stream()

    def bind_stream(self) -> None:
        """Launch on the device's current stream from now on."""
        if self.on_cuda:
            self._stream = torch.cuda.current_stream(self.device).cuda_stream

    def _check(self, requests, *state) -> list:
        """The requests' members, each in range and named once, after the
        state columns' checks."""
        for t in state:
            if (t.device != self.device or t.dtype != torch.int32
                    or tuple(t.shape) != (self.batch, self.n)
                    or not t.is_contiguous()):
                raise ValueError(
                    f"state columns must be contiguous int32[{self.batch}, "
                    f"{self.n}] on {self.device}, got {t.dtype}"
                    f"{list(t.shape)} on {t.device}")
        members = [r[0] for r in requests]
        if not all(0 <= b < self.batch for b in members):
            raise ValueError(f"members must lie in [0, {self.batch}), got "
                             f"{sorted(set(members))}")
        if len(set(members)) != len(members):
            raise ValueError("at most one request a member in one call")
        return members

    def _pack(self, members, jstate, rsv_finish, words,
              nodes=None) -> ctypes.Array:
        """The ``SelectArgs`` of each request, packed into a host buffer:
        member ``b``'s columns (its row of ``nodes`` for the node column,
        when given) and state rows, then ``words`` (the mode and the
        PARAMS)."""
        js, rsv, row = jstate.data_ptr(), rsv_finish.data_ptr(), 4 * self.n
        for r, (b, w) in enumerate(zip(members, words)):
            cols = self._cols_of[b]
            if nodes is not None:
                cols = (*cols[:2], nodes.data_ptr() + b * row, cols[3])
            _ARGS_PACK.pack_into(self._args, r * _ARGS_PACK.size,
                                 *cols, js + b * row, rsv + b * row, self.n,
                                 *w)
        return self._args

    def _launch(self, fn, members, jstate, rsv_finish, nodes, words) -> list:
        """Launch ``fn`` once for the requests of ``members`` and return
        its answers, 4 ints a request, in request order."""
        n = len(members)
        args = self._pack(members, jstate, rsv_finish, words, nodes)
        err = fn(ctypes.addressof(args), n, self._stream,
                 ctypes.addressof(self._answers))
        if err != 0:
            raise RuntimeError(f"queue_select batched launch of {n} "
                               f"requests: CUDA error {err}")
        return self._answers[:4 * n]

    def select_batch(self, requests, jstate: torch.Tensor,
                     nodes: torch.Tensor | None = None) -> list:
        """``(index, score)`` for each ``(member, mode, params)`` request:
        the masked lexicographic argmin of the mode's key and mask over the
        member's rows (``ref.fused_key_mask``), ``(-1, BIG)`` when none is
        feasible.  ``nodes`` (``[B, J]``) replaces the table's node column
        for this call."""
        if not requests:
            return []
        members = self._check(requests, jstate,
                              *(() if nodes is None else (nodes,)))
        if not self.on_cuda:
            modes, params, active = ([0] * self.batch, [None] * self.batch,
                                     [False] * self.batch)
            for b, mode, p in requests:
                modes[b], active[b] = mode, True
                params[b] = dict(zip(PARAMS[:-1], p[:-1]))
            cols = self.cols if nodes is None else {**self.cols,
                                                    "nodes": nodes}
            got = fused_select_batched_reference(modes, cols, jstate,
                                                 params, active)
            return [got[b] for b in members]
        out = self._launch(self._lib.queue_select_fused_batch, members,
                           jstate, jstate, nodes,
                           [(mode, *p) for _, mode, p in requests])
        queue_select.batch_launches += 1
        queue_select.batch_selections += len(members)
        return [(out[i], out[i + 1]) for i in range(0, len(out), 4)]

    def walk_batch(self, requests, jstate: torch.Tensor,
                   rsv_finish: torch.Tensor,
                   nodes: torch.Tensor | None = None) -> list:
        """``(shadow, extra, k_row)`` for each ``(member, params)`` request:
        the EASY shadow walk over the member's running rows with its
        ``clock``, ``free`` and ``head_need`` (``ref.shadow_walk_reference``).
        ``nodes`` (``[B, J]``) replaces the table's node column for this
        call."""
        if not requests:
            return []
        members = self._check(requests, jstate, rsv_finish,
                              *(() if nodes is None else (nodes,)))
        if not self.on_cuda:
            params, active = [None] * self.batch, [False] * self.batch
            for b, p in requests:
                params[b], active[b] = dict(zip(PARAMS, p)), True
            got = shadow_walk_batched_reference(
                self.cols["nodes"] if nodes is None else nodes, jstate,
                rsv_finish, params, active)
            return [got[b] for b in members]
        out = self._launch(self._lib.queue_select_walk_batch, members, jstate,
                           rsv_finish, nodes, [(0, *p) for _, p in requests])
        shadow_walk.batch_launches += 1
        shadow_walk.batch_walks += len(members)
        shadow_walk.batch_steps += sum(out[3::4])
        return [tuple(out[i:i + 3]) for i in range(0, len(out), 4)]


__all__ = ["MODES", "BatchedTableSelect", "TableSelect", "queue_select",
           "reset_launches", "shadow_walk"]
