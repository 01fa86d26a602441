"""Device meshes of the PyTorch port (counterpart of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of an
initialised process group, one rank a process.  The caller initialises the
group (``torchrun``, or :func:`spawn_world` on one host); importing this
module touches no device state.

The simulator's mesh entries (``core.parallel``, ``api.sweep``) move small
host tensors between ranks, so the group is a gloo group with a finite
``timeout``, on the card as on the CPU: NCCL refuses two ranks on one
card, and nothing swaps backends when one fails.  A rank runs on the CPU
only in a ``cpu`` mesh; a rank of a ``cuda`` mesh without its card raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import queue as _queue
import socket
import time
import traceback

import torch

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of global rank ``rank`` in a mesh of ``device_type``: the
    CPU, or card ``rank % torch.cuda.device_count()``.  Ranks share a card
    only when the world has more ranks than the host has cards (two ranks
    on the one card of a one-card host)."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for a rank of a cuda "
                           "mesh; build the mesh with device_type='cpu' to "
                           "run the plain PyTorch path on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def mesh_device(mesh, device=None) -> torch.device:
    """This rank's device in ``mesh`` (:func:`rank_device`).  A ``device``
    given must be that one: ``cpu`` only with a cpu mesh, a card only with
    a cuda mesh and the rank's own card."""
    import torch.distributed as dist
    want = rank_device(mesh.device_type, dist.get_rank())
    if device is None:
        return want
    got = torch.device(device)
    if got.type == "cuda" and got.index is None and want.type == "cuda":
        got = want
    if got != want:
        raise ValueError(f"device {got} contradicts the mesh: rank "
                         f"{dist.get_rank()} of a {mesh.device_type} mesh "
                         f"runs on {want}")
    return want


def _world() -> tuple:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("initialise the process group first (torchrun, "
                           "or spawn_world), with backend='gloo'")
    return dist.get_rank(), dist.get_world_size()


_ALL_GATHER_LIB = None


def _all_gather_into_tensor(input, group_size, group_name):
    """``_c10d_functional.all_gather_into_tensor`` on CUDA tensors through
    the group's own ``all_gather_into_tensor``, completed before it
    returns.  The functional op's own kernel goes through the group's
    coalesced all-gather, which a gloo group cannot run on CUDA tensors
    (its process dies of a segmentation fault: ``scripts/
    shard_gloo_probe.py``); DTensor gathers a shard with it."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    out = input.new_empty((input.shape[0] * group_size,)
                          + tuple(input.shape[1:]))
    dist.all_gather_into_tensor(out, input.contiguous(),
                                group=_resolve_process_group(group_name))
    return out


def route_cuda_all_gather() -> None:
    """Register :func:`_all_gather_into_tensor` as the CUDA kernel of the
    functional all-gather, once a process (a mesh of cards over gloo needs
    it before DTensor gathers a shard).  It holds for the whole process:
    every group's functional all-gather then blocks, NCCL's too, so only
    a process whose groups are gloo's registers it."""
    global _ALL_GATHER_LIB
    if _ALL_GATHER_LIB is None:
        _ALL_GATHER_LIB = torch.library.Library("_c10d_functional", "IMPL")
        _ALL_GATHER_LIB.impl("all_gather_into_tensor",
                             _all_gather_into_tensor, "CUDA")


def make_local_mesh(axes=("data", "model"), device_type: str = "cuda",
                    shape=None):
    """The ranks of the initialised process group as a mesh of ``axes``
    and ``shape`` (its product the world size; by default every rank on
    the first axis, the other axes of size 1: the tests' and examples'
    mesh), ranks in row-major order.  An axis that spans the whole world
    is the world's own group, so it keeps the caller's backend and
    timeout; the others are subgroups of the same backend.  On cuda each
    rank's current device is set to its card first, and over a gloo group
    DTensor's all-gather is routed around gloo's coalesced one
    (:func:`route_cuda_all_gather`; another backend keeps its own)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    rank, world = _world()
    dev = rank_device(device_type, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if dist.get_backend() == "gloo":
            route_cuda_all_gather()
    axes = tuple(axes)
    shape = (world,) + (1,) * (len(axes) - 1) if shape is None else tuple(
        shape)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} over axes {axes} does "
                         f"not hold the world's {world} ranks")
    layout = torch.arange(world).reshape(shape)
    if len(axes) == 1:
        return DeviceMesh.from_group(dist.group.WORLD, device_type,
                                     mesh_dim_names=axes)
    # each axis's groups (the ranks along it, the other coordinates fixed),
    # made by every rank in the same order as new_group requires
    own = []
    for d in range(len(axes)):
        if shape[d] == world:
            own.append(dist.group.WORLD)
            continue
        lines = layout.movedim(d, -1).reshape(-1, shape[d]).tolist()
        groups = [(ranks, dist.new_group(ranks)) for ranks in lines]
        own.append(next(g for ranks, g in groups if rank in ranks))
    return DeviceMesh.from_group(own, device_type, mesh=layout,
                                 mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 single-pod (256 ranks) or 2 x 16 x 16 multi-pod (512
    ranks) of cards; any other world size raises, naming the size it
    needs."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION[bool(multi_pod)]
    rank, world = _world()
    need = math.prod(shape)
    if world != need:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod "
                         f"production mesh {shape} needs a world of {need} "
                         f"ranks, got {world}")
    torch.cuda.set_device(rank_device("cuda", rank))
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def mesh_num_devices(mesh) -> int:
    """The number of ranks in ``mesh`` (the product of its axes)."""
    return mesh.size()


# ---------------------------------------------------------------------------
# one host's world of ranks
# ---------------------------------------------------------------------------


class WorldError(RuntimeError):
    """Ranks of a :func:`spawn_world` raised: ``failures`` maps each such
    rank to its traceback, ``results`` the other ranks to their values."""

    def __init__(self, failures: dict, results: dict):
        self.failures, self.results = failures, results
        super().__init__("; ".join(
            f"rank {r}: {tb.strip().splitlines()[-1]}"
            for r, tb in sorted(failures.items())))


@dataclasses.dataclass(frozen=True)
class _Rank:
    world: int
    port: int
    fn: object
    args: tuple
    device_type: str
    group_timeout: float


def _rank_main(rank: int, spec: _Rank, out) -> None:
    import torch.distributed as dist
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{spec.port}", rank=rank,
            world_size=spec.world,
            timeout=datetime.timedelta(seconds=spec.group_timeout))
        mesh = make_local_mesh(("sim",), spec.device_type)
        out.put((rank, ("ok", spec.fn(mesh, *spec.args))))
    except BaseException:
        out.put((rank, ("err", traceback.format_exc())))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(fn, world_size: int, *, args=(), device_type: str = "cuda",
                timeout: float = 300.0, group_timeout: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` fresh processes of this
    host (``spawn``: safe after CUDA is initialised), one rank each, over a
    gloo group on a free localhost port whose collectives time out after
    ``group_timeout`` seconds; each rank's mesh is
    ``make_local_mesh(("sim",), device_type)``.  ``fn`` must be importable
    by name, its return value picklable, and the caller's main module
    guarded by ``if __name__ == "__main__"`` (each rank imports it).

    Returns the ranks' values in rank order.  Raises :class:`WorldError`
    when a rank raised (or died), and ``TimeoutError`` when the world has
    not ended within ``timeout`` seconds; either way every rank process is
    ended before this returns."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    spec = _Rank(world_size, _free_port(), fn, tuple(args), device_type,
                 float(group_timeout))
    procs = [ctx.Process(target=_rank_main, args=(r, spec, out), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got: dict = {}
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size - len(got)} of {world_size} ranks had not "
                    f"ended after {timeout} s")
            try:
                rank, res = out.get(timeout=min(left, 1.0))
                got[rank] = res
            except _queue.Empty:
                # a rank's message is flushed before it exits: one that has
                # exited while nothing waits in the queue never sent one
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode is not None and out.empty():
                        got[r] = ("err", f"rank {r} exited with code "
                                  f"{p.exitcode} and no result")
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    failures = {r: v for r, (k, v) in got.items() if k == "err"}
    results = {r: v for r, (k, v) in got.items() if k == "ok"}
    if failures:
        raise WorldError(failures, results)
    return [results[r] for r in range(world_size)]
