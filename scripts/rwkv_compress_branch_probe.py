"""Where the compressed rwkv golden run leaves the JAX trainer's steps
under a rounding-level change.

``tests/data/torch_train_golden.json``'s ``rwkv6-7b/compress`` entry
(reduced rwkv6-7b at an ill-conditioned point, int8 gradient compression
with error feedback, 8 steps) is run by the port's one-device trainer
three times: as it is, with the embedding table scaled by ``1 + 2^-23``
(one ulp), and with the log-sum-exp of the loss taken from the max and
sum reductions (the form the sharded layout uses).  Each run's grad norm
a step is printed beside the JAX trainer's, as one JSON line a run.  A
step where the changed runs part from the JAX trainer by more than the
entry's tolerance while the plain run does not is a bifurcation of the
run itself, not of the code that perturbs it.

With ``--mesh RxC`` the entry is trained instead over a ``("data",
"model")`` mesh of two gloo ranks (``spawn_world``) and on one device on
each rank, and the line also names the first int8 payload element that
differs between the two (step, leaf, rank, element, the quantizer's
inputs and outputs).

    PYTHONPATH=src python scripts/rwkv_compress_branch_probe.py [--device cuda] [--mesh 1x2]
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, numpy_lm_params  # noqa: E402
from repro_torch.data.pipeline import DataState  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, compression_init  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "data", "torch_train_golden.json")


class Windows:
    """The entry's token windows, step by step (as the JAX host drew them)."""

    def __init__(self, windows):
        self.windows = [np.asarray(w, np.int32) for w in windows]
        self.state = DataState(seed=0, step=0)

    def __next__(self):
        w = self.windows[self.state.step]
        self.state.step += 1
        return {"tokens": w[:, :-1], "labels": w[:, 1:]}


@contextlib.contextmanager
def reduction_lse():
    """``torch.logsumexp`` as max + log(sum(exp(x - max)))."""
    orig = torch.logsumexp

    def lse(x, dim):
        top = torch.amax(x, dim=dim).detach()
        return top + torch.log(torch.sum(torch.exp(x - top.unsqueeze(dim)),
                                         dim=dim))
    torch.logsumexp = lse
    try:
        yield
    finally:
        torch.logsumexp = orig


def run(g, device, tok_scale=1.0, mesh=None, ckpt_dir=None):
    """The entry's run; returns (each step's grad norm, the trainer)."""
    cfg = get_config(g["arch"]).reduced()
    tree = numpy_lm_params(cfg, **g["weights"])
    tree["embed"]["tok"] = (tree["embed"]["tok"]
                            * np.float32(tok_scale)).astype(np.float32)
    with contextlib.ExitStack() as stack:
        d = ckpt_dir or stack.enter_context(tempfile.TemporaryDirectory())
        tr = Trainer(cfg, AdamWConfig(**g["opt"]), TrainerConfig(
            ckpt_dir=d, log_every=10**9, **g["trainer"]),
            Windows(g["tokens"]), log=lambda *_: None, device=device,
            mesh=mesh)

        def init_state():
            p = lm_params_from_numpy(tree, device)
            return p, adamw_init(p), compression_init(p)
        tr._init_state = init_state
        tr.run()
    return [m["grad_norm"] for m in tr.metrics], tr


def mesh_rank(_, shape, device_type):
    """One rank of ``--mesh``: the entry over the mesh and on one device,
    each int8 payload recorded; the first element that differs."""
    import torch.distributed as dist
    from repro_torch.launch import make_local_mesh
    from repro_torch.optim import compression
    from repro_torch.sharding.rules import local_slice
    from repro_torch.tree import tree_items
    rank = dist.get_rank()
    g = entry()
    mesh = make_local_mesh(("data", "model"), device_type, shape=shape)
    device = "cpu" if device_type == "cpu" else None
    orig, out = compression._quantize_int8, {}
    for name, m in (("mesh", mesh), ("one", None)):
        calls = []

        def spy(x, absmax=None):
            q, scale = orig(x, absmax)
            calls.append((x.cpu(), q.cpu()))
            return q, scale
        compression._quantize_int8 = spy
        box = [tempfile.mkdtemp() if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        try:
            norms, tr = run(g, device or "cuda", mesh=m,
                            ckpt_dir=f"{box[0]}/{name}{rank}")
        finally:
            compression._quantize_int8 = orig
        out[name] = (norms, calls)
        if m is not None:
            leaves = [(k, p.placements) for k, p in tree_items(tr.state[0])]
    first = None
    for i, ((xm, qm), (xo, qo)) in enumerate(zip(out["mesh"][1],
                                                 out["one"][1])):
        step, j = divmod(i, len(leaves))
        path, place = leaves[j]
        xo, qo = (local_slice(t, mesh, place) for t in (xo, qo))
        diff = (qm.int() - qo.int()).flatten().abs()
        if first is None and diff.max() > 0:
            e = int(diff.argmax())
            first = {"step": step, "leaf": path, "rank": rank, "element": e,
                     "elements_differing": int((diff > 0).sum()),
                     "input_mesh": float(xm.flatten()[e]),
                     "input_one": float(xo.flatten()[e]),
                     "q_mesh": int(qm.flatten()[e]),
                     "q_one": int(qo.flatten()[e])}
    return {"rank": rank, "mesh_grad_norm": out["mesh"][0],
            "one_grad_norm": out["one"][0], "first_payload_diff": first}


def entry():
    return next(e for e in json.load(open(GOLDEN))
                if e["name"] == "rwkv6-7b/compress")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--mesh", default=None, help="RxC: two gloo ranks")
    args = ap.parse_args()
    device = args.device
    torch.backends.cuda.matmul.allow_tf32 = False
    g = entry()
    want = [s["grad_norm"] for s in g["steps"]]
    tol = g["tol"]["grad_norm"]
    if args.mesh:
        from repro_torch.launch import spawn_world
        shape = tuple(int(n) for n in args.mesh.split("x"))
        for r in spawn_world(mesh_rank, shape[0] * shape[1],
                             args=(shape, device), device_type=device,
                             timeout=600, group_timeout=120):
            print(json.dumps({"mesh": args.mesh, "device": device,
                              "jax_grad_norm": want, "tol": tol, **r}))
        return 0
    runs = {"plain": run(g, device)[0],
            "tok_one_ulp": run(g, device, 1 + 2**-23)[0]}
    with reduction_lse():
        runs["reduction_lse"] = run(g, device)[0]
    for name, got in runs.items():
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        print(json.dumps({"run": name, "device": device, "grad_norm": got,
                          "jax_grad_norm": want, "rel_err": rel,
                          "steps_off": [i for i, r in enumerate(rel)
                                        if r > tol], "tol": tol}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
