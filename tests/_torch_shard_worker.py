"""The ranks' side of ``tests/test_torch_shard_train.py``: functions that
``repro_torch.launch.spawn_world`` runs on every rank of a gloo world on
the CPU, over a ``("data", "model")`` mesh of the shape the test names.
They import only the port (never JAX, so a rank starts fast), hold each
mesh result against the ``mesh=None`` result on the rank itself, and
return the differences and, on rank 0, the mesh results as numpy for the
test to hold against the JAX package."""

import dataclasses
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import make_local_mesh
from repro_torch.models.api import get_model
from repro_torch.optim import (
    AdamWConfig, CompressionState, adamw_init, compression_init,
)
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sharding.rules import (
    LONG_DECODE_RULES, PREFILL_RULES, SERVE_RULES, TRAIN_RULES,
    distribute_tree, like, mesh_of,
)
from repro_torch.tree import tree_items, tree_map

# the families the sharded layout reaches, one arch each
ARCHS = ("llama3.2-3b", "rwkv6-7b", "mixtral-8x7b", "zamba2-2.7b",
         "qwen2-vl-72b", "seamless-m4t-medium")
BATCH, SEQ = 4, 16
N_FRONT = 4         # a vlm batch's patches; an encoder-decoder's source is SEQ
# the trainer run: 6 steps of 2 microbatches, compression on, a fault at
# step 3 rolled back to the step-2 checkpoint
TRAIN_ARCH = "llama3.2-3b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)
TCFG = dict(steps=6, accum=2, compress_grads=True, ckpt_every=2,
            inject_failure_at=3)
SERVE_RULE_SETS = {r.name: r for r in (PREFILL_RULES, SERVE_RULES,
                                       LONG_DECODE_RULES)}
PROMPT, GEN = 12, 4


def config(arch):
    return get_config(arch).reduced()


def weights(arch, seed=0):
    """Seeded numpy weights: the leaves the initializer leaves at zero or
    one drawn live, attention at its true fan-in (as
    ``tests/_torch_train.py`` and ``tests/_torch_lm.py``)."""
    rwkv = config(arch).family == "rwkv"
    return numpy_lm_params(config(arch), seed, live_seed=3 if rwkv else 1,
                           fan_in=not rwkv)


def tokens(arch, batch=BATCH, seq=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, config(arch).vocab, (batch, seq + 1)).astype(
        np.int32)


def inputs(arch, batch=BATCH, seq=SEQ, seed=0) -> dict:
    """A batch as numpy: ``tokens`` and ``labels`` ``[batch, seq]``, and a
    vlm's ``patches`` or an encoder-decoder's ``src_embeds``."""
    cfg = config(arch)
    toks = tokens(arch, batch, seq, seed)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, N_FRONT, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = rng.standard_normal(
            (batch, seq, cfg.d_model), dtype=np.float32)
    return out


def _np(x) -> np.ndarray:
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().float().cpu().numpy()


def loss_and_grads(arch, mesh, rules=TRAIN_RULES, device="cpu"):
    """``loss_fn`` of the arch's weights on one batch and every leaf's
    gradient, as numpy: ``(loss, {path: grad})``."""
    model = get_model(config(arch))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in inputs(arch).items()}
    params = lm_params_from_numpy(weights(arch), device).tree()
    params = tree_map(lambda p: p.detach().clone(), params)
    if mesh is not None:
        params = distribute_tree(params, model.param_specs(rules, mesh), mesh)
    params = tree_map(lambda p: p.requires_grad_(), params)
    loss, _ = model.loss_fn(params, batch, rules=rules, mesh=mesh)
    loss.backward()
    return float(_np(loss)), {k: _np(p.grad) for k, p in tree_items(params)}


def trainer(arch, mesh, ckpt_dir, **over):
    """The port's trainer on the CPU from the arch's numpy weights."""
    cfg = config(arch)
    compress = {**TCFG, **over}.get("compress_grads", False)
    tr = Trainer(cfg, AdamWConfig(**OPT), TrainerConfig(
        ckpt_dir=ckpt_dir, log_every=10**9, **{**TCFG, **over}),
        SyntheticTokens(cfg.vocab, BATCH, SEQ, seed=0), log=lambda *_: None,
        device="cpu", mesh=mesh)
    tree = weights(arch)

    def init_state():
        p = lm_params_from_numpy(tree, "cpu")
        return p, adamw_init(p), (
            compression_init(p) if compress
            else CompressionState(residual=torch.zeros(())))

    tr._init_state = init_state
    return tr


def params_np(params) -> dict:
    return {k: _np(p) for k, p in tree_items(params)}


def train_run(mesh, ckpt_dir: str) -> dict:
    """The trainer's run (over ``mesh``, or on one device): each executed
    step's metrics, the restarts and the final parameters as numpy."""
    tr = trainer(TRAIN_ARCH, mesh, ckpt_dir)
    res = tr.run()
    return {"steps": [h["step"] for h in res["history"]],
            "restarts": res["restarts"], "metrics": tr.metrics,
            "params": params_np(tr.state[0])}


def restored_params(ckpt_dir: str) -> dict:
    """A one-device trainer's parameters restored from ``ckpt_dir``'s
    newest checkpoint, and its step."""
    from repro_torch.ckpt.store import CheckpointManager
    tr = trainer(TRAIN_ARCH, None, ckpt_dir)
    params, _, _, step = tr._restore_or_init(CheckpointManager(ckpt_dir))
    return params_np(params), step


def serve_run(arch, rules, mesh, device="cpu") -> tuple:
    """Prefill and greedy decode steps of ``arch`` (under ``rules`` over
    ``mesh``, or on one device): each step's logits and the tokens."""
    cfg = dataclasses.replace(config(arch), use_pallas=True)
    model = get_model(cfg)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in inputs(arch, 2, PROMPT, seed=1).items()
             if k != "labels"}
    params = lm_params_from_numpy(weights(arch), device).tree()
    if mesh is not None:
        params = distribute_tree(tree_map(lambda p: p.detach(), params),
                                 model.param_specs(rules, mesh), mesh)
    return _serve(model, params, batch, rules, mesh)


def _serve(model, params, batch, rules, mesh):
    kw = {} if mesh is None else {"rules": rules, "mesh": mesh}
    logits, cache = model.prefill(params, batch, **kw)
    seen, out = [_np(logits)], []
    start = batch["tokens"].shape[1] + (
        batch["patches"].shape[1] if "patches" in batch else 0)
    cache = _grow(cache, GEN)
    dev = batch["tokens"].device
    for i in range(GEN):
        nxt = torch.from_numpy(seen[-1].argmax(-1)).long().to(dev)
        out.append(nxt.tolist())
        logits, cache = model.decode_step(params, nxt, start + i, cache,
                                          **kw)
        seen.append(_np(logits))
    return seen, out


def _grow(cache, n: int):
    """A prefill's K/V (under ``self`` for an encoder-decoder, ``attn``
    for a hybrid model) with ``n`` more positions of zeros, for the decode
    steps; a recurrent cache as it is."""
    for key in ("self", "attn"):     # encoder-decoder, hybrid
        if key in cache:
            return {**cache, key: _grow(cache[key], n)}
    if "k" not in cache:
        return cache
    out = {}
    for name, t in cache.items():
        shape = t.shape[:2] + (n,) + t.shape[3:]
        zeros = torch.zeros(shape, dtype=t.dtype, device=(
            t.device if mesh_of(t) is None else t.to_local().device))
        out[name] = torch.cat([t, like(zeros, t)], dim=2)
    return out


def world_checks(_, shape, serve_rules: str) -> dict:
    """Every case over a ``("data", "model")`` mesh of ``shape``, the
    serving entries under the rule set named ``serve_rules``; rank 0
    returns the results (every rank computes them: the collectives need
    all)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    mesh = make_local_mesh(("data", "model"), "cpu", shape=shape)
    rank = dist.get_rank()
    out = {"grads": {arch: loss_and_grads(arch, mesh) for arch in ARCHS}}
    root = _shared_dir(rank)
    out["train"] = train_run(mesh, f"{root}/mesh")
    dist.barrier()
    if rank == 0:
        out["restored"] = restored_params(f"{root}/mesh")
        shutil.rmtree(root, ignore_errors=True)
    out["serve"] = {arch: serve_run(arch, SERVE_RULE_SETS[serve_rules], mesh)
                    for arch in ARCHS}
    return out if rank == 0 else {}


def _shared_dir(rank: int) -> str:
    """One temporary directory for every rank (rank 0 makes it)."""
    import torch.distributed as dist
    box = [tempfile.mkdtemp(prefix="shard_ckpt_") if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]
