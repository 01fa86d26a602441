"""Which collectives a gloo group takes on CUDA tensors (H100).

Two ranks share the one card over gloo (NCCL refuses two ranks on one
card), as ``chip_smoke.py``'s phases mesh and shard run them.  Each
``torch.distributed`` collective that DTensor's redistributes issue, and
each redistribute itself, runs on CUDA tensors in a world of its own (a
refused collective may end its process with a signal); the script
reports for each whether it ran, whether its numbers are right, and its
wall time over a 64 MiB f32 tensor, one JSON line a collective.

    python3 scripts/shard_gloo_probe.py [NAME ...]     # all, or the named
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

N = 1 << 24      # f32 elements of the timed tensors
OPS = ("all_reduce", "all_gather_into_tensor", "all_gather",
       "reduce_scatter_tensor", "all_to_all_single", "broadcast",
       "dtensor_shard_to_replicate", "dtensor_partial_to_shard",
       "dtensor_partial_to_replicate", "dtensor_shard0_to_shard1",
       "funcol_all_gather", "dtensor_shard_to_replicate_routed",
       "mesh2x1_shard_to_replicate_routed",
       "mesh1x2_shard_to_replicate_routed")


def _try(name, fn, want, out):
    import torch
    if name != out["only"]:
        return
    try:
        t = time.time()
        got = fn()
        torch.cuda.synchronize()
        dt = time.time() - t
        ok = bool(torch.equal(got.cpu(), want.cpu()))
        out[name] = {"ran": True, "right": ok, "s": dt}
    except Exception as e:   # a probe: a refusal is its answer
        out[name] = {"ran": False, "error": f"{type(e).__name__}: "
                     f"{str(e).splitlines()[0][:200]}"}


def rank_main(mesh, only):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch import make_local_mesh
    from repro_torch.launch.mesh import route_cuda_all_gather
    if only.endswith("_routed"):
        route_cuda_all_gather()
    rank, R = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    full = torch.arange(R * N, dtype=torch.float32, device=dev)
    mine = full.chunk(R)[rank].clone()
    out = {"only": only}

    def allreduce():
        x = full.clone()
        dist.all_reduce(x)
        return x
    _try("all_reduce", allreduce, full * R, out)

    def allgather():
        x = torch.empty_like(full)
        dist.all_gather_into_tensor(x, mine)
        return x
    _try("all_gather_into_tensor", allgather, full, out)

    def allgather_list():
        xs = [torch.empty_like(mine) for _ in range(R)]
        dist.all_gather(xs, mine)
        return torch.cat(xs)
    _try("all_gather", allgather_list, full, out)

    def reduce_scatter():
        x = torch.empty_like(mine)
        dist.reduce_scatter_tensor(x, full)
        return x
    _try("reduce_scatter_tensor", reduce_scatter, mine * R, out)

    def all_to_all():
        x = torch.empty_like(full)
        dist.all_to_all_single(x, full)
        return x
    a2a = torch.cat([full.chunk(R)[rank]] * R)
    _try("all_to_all_single", all_to_all, a2a, out)

    def broadcast():
        x = full.clone() if rank == 0 else torch.zeros_like(full)
        dist.broadcast(x, 0)
        return x
    _try("broadcast", broadcast, full, out)

    m2 = full.reshape(R * 64, -1)
    sh = DTensor.from_local(m2.chunk(R)[rank].clone(), mesh, [Shard(0)])
    part = DTensor.from_local(m2.clone(), mesh, [Partial()])
    _try("dtensor_shard_to_replicate",
         lambda: sh.redistribute(mesh, [Replicate()]).to_local(), m2, out)
    _try("dtensor_partial_to_shard",
         lambda: part.redistribute(mesh, [Shard(0)]).to_local(),
         (m2 * R).chunk(R)[rank], out)
    _try("dtensor_partial_to_replicate",
         lambda: part.redistribute(mesh, [Replicate()]).to_local(), m2 * R,
         out)
    _try("dtensor_shard0_to_shard1",
         lambda: sh.redistribute(mesh, [Shard(1)]).to_local(),
         m2.chunk(R, dim=1)[rank], out)

    def funcol():
        x = torch.ops._c10d_functional.all_gather_into_tensor(
            mine, R, mesh.get_group(0).group_name)
        return torch.ops._c10d_functional.wait_tensor(x)
    _try("funcol_all_gather", funcol, full, out)
    _try("dtensor_shard_to_replicate_routed",
         lambda: sh.redistribute(mesh, [Replicate()]).to_local(), m2, out)
    for shape in ((2, 1), (1, 2)):
        name = f"mesh{shape[0]}x{shape[1]}_shard_to_replicate_routed"
        if name != only:
            continue
        m = make_local_mesh(("data", "model"), "cuda", shape=shape)
        d = [i for i in range(2) if shape[i] == 2][0]
        place = [Replicate(), Replicate()]
        place[d] = Shard(1)
        x = DTensor.from_local(m2.chunk(R, dim=1)[rank].clone(), m, place)
        _try(name, lambda: x.redistribute(m, [Replicate(), Replicate()])
             .to_local(), m2, out)
    return {"rank": rank, "torch": torch.__version__,
            "cuda": torch.version.cuda, "mib": 4 * N / 2**20, **out}


def main():
    import torch
    from repro_torch.launch import spawn_world
    if not torch.cuda.is_available():
        print("shard_gloo_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch import WorldError
    for name in sys.argv[1:] or OPS:
        try:
            ranks = spawn_world(rank_main, 2, args=(name,),
                                device_type="cuda", timeout=120,
                                group_timeout=60)
        except (WorldError, TimeoutError) as e:
            ranks = {"world_failed": str(e)[:300]}
        print(json.dumps({name: ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
