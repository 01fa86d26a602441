"""Fault-tolerant training loop on one device.

Counterpart of ``repro.runtime.trainer``.  The data stream is a pure
function of the step counter (``repro_torch.data``), so (params, optimizer
state, data step) restored from the last checkpoint resume the exact
gradient sequence.  Failures (real or injected) roll back to the last
checkpoint and replay; straggler decisions are logged through
``StragglerMonitor``; int8 gradient compression with error feedback is
applied where the reduction would be, when enabled.

A step runs eagerly where the reference runs one jitted function: each
microbatch's ``loss_fn`` is differentiated by its own backward pass into
gradient buffers that persist across steps, the sum is divided by the
microbatch count, then compression (optional) and ``adamw_update`` update
the parameters and moments in place.  Autograd differentiates a view of
the parameters in which each stacked ``[L, ...]`` layer leaf is a list of
per-layer leaves sharing its storage, each with its slice of the stacked
gradient buffer as ``.grad``: a layer's backward pass then adds into its
own slice instead of building a full ``[L, ...]`` gradient for every layer.

Over a mesh (``Trainer(mesh=, rules=)``, the sharded layout) the
parameters, gradient buffers, both moments and the compression residuals
are DTensors with each parameter's placements (``ModelAPI.param_specs``).
Every rank draws the same pipeline step and the model takes each rank's
rows (``batch``).  After each microbatch's backward pass a layer's gradient
(a partial sum where the batch was split) is redistributed to its
parameter's placements and added into the rank's shard of its buffer;
compression and AdamW then run on local shards, with the clip norm and
each leaf's quantization scale reduced over the mesh.  Checkpoints hold
whole arrays, written by the mesh's first rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.ckpt.store import CheckpointManager, latest_step
from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobs import resolve_device
from repro_torch.launch.mesh import mesh_device
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import (
    AdamWConfig, OptState, adamw_init, adamw_update,
)
from repro_torch.optim.compression import (
    CompressionState, compress_gradients, compression_init,
)
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.sharding.rules import (
    TRAIN_RULES, distribute_tree, local, mesh_of,
)
from repro_torch.tree import as_tree, tree_leaves, tree_map


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 2
    async_ckpt: bool = False
    log_every: int = 10
    compress_grads: bool = False
    accum: int = 1                      # gradient accumulation microbatches
    inject_failure_at: Optional[int] = None
    max_restarts: int = 3
    seed: int = 0


class _InjectedFailure(RuntimeError):
    pass


def _trainable_view(params, grads, pairs=None):
    """The leaves autograd differentiates: each leaf of ``params`` detached
    (sharing its storage) with its ``grads`` buffer as ``.grad``, and each
    stacked leaf under ``blocks`` as a list of such per-layer leaves.

    With ``pairs`` (a list, over a mesh) no ``.grad`` is set: each view
    leaf is appended with this rank's shard of its buffer (a layer's slice
    for a stacked leaf), for :meth:`Trainer._fold_grads`."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        if pairs is None:
            t.grad = g
        else:
            pairs.append((t, g))
        return t

    return {k: tree_map(
        (lambda p, g: [leaf(p[i], local(g)[i]) for i in range(p.shape[0])])
        if k == "blocks" else (lambda p, g: leaf(p, local(g))), x, grads[k])
        for k, x in params.items()}


def _plain(x: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor gathered)."""
    return x if mesh_of(x) is None else x.full_tensor()


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainerConfig, dataset, *, mesh=None,
                 rules=TRAIN_RULES, log: Callable[[str], None] = print,
                 device=None):
        """``device`` defaults to cuda and raises without a card; CPU
        callers pass ``device="cpu"``.  Over ``mesh`` (a ``DeviceMesh``
        with the ``rules``' axes) the device is the rank's own
        (``launch.mesh.mesh_device``: a ``cuda`` mesh runs on the cards, a
        ``cpu`` mesh on the CPU)."""
        if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, "
                            f"got {type(mesh).__name__}")
        self.mesh, self.rules = mesh, rules
        self.device = (resolve_device(device) if mesh is None
                       else mesh_device(mesh, device))
        self.model = get_model(model_cfg)
        self.cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.ds = dataset
        self.log = log
        self.monitor = StragglerMonitor(1)
        self.history: list[Dict[str, float]] = []
        self.metrics: list[Dict[str, float]] = []   # each step's metrics
        self.restarts = 0

    # ------------------------------------------------------------------
    def _bind(self, params) -> None:
        """Gradient buffers and the trainable view for ``params``."""
        self._grads = tree_map(torch.zeros_like, params)
        self._pairs = None if self.mesh is None else []
        self._view = _trainable_view(params, self._grads, self._pairs)

    @torch.no_grad()
    def _fold_grads(self) -> None:
        """Over a mesh, after a backward pass: each view leaf's gradient
        redistributed to its parameter's placements (a partial sum is
        reduced) and added into this rank's shard of its buffer."""
        if self.mesh is None:
            return
        for t, g in self._pairs:
            if t.grad is not None:
                g.add_(t.grad.redistribute(self.mesh, t.placements)
                       .to_local())
                t.grad = None

    def _loss(self, batch):
        loss, m = self.model.loss_fn(self._view, batch, rules=self.rules,
                                     mesh=self.mesh)
        loss.backward()
        self._fold_grads()
        return _plain(loss.detach()), {k: _plain(x.detach())
                                        for k, x in m.items()}

    def _distribute(self, params, opt, comp):
        """Full trees (the same on every rank) as DTensors of each
        parameter's placements."""
        specs = self.model.param_specs(self.rules, self.mesh)

        def dist(tree):
            return distribute_tree(tree_map(torch.Tensor.detach, tree), specs,
                                   self.mesh)

        residual = comp.residual
        if isinstance(residual, dict):
            residual = dist(residual)
        return (dist(params), OptState(m=dist(opt.m), v=dist(opt.v),
                                       step=opt.step),
                CompressionState(residual=residual))

    def _train_step(self, params, opt, comp, batch):
        for g in tree_leaves(self._grads):
            g.zero_()
        accum = self.tcfg.accum
        if accum > 1:
            ces = []
            for i in range(accum):
                mb = {k: x.reshape((accum, -1) + x.shape[1:])[i]
                      for k, x in batch.items()}
                ces.append(self._loss(mb)[1]["ce"])
            n = torch.tensor(float(accum), device=self.device)
            for g in tree_leaves(self._grads):
                local(g).div_(n)
            loss = torch.stack(ces).mean()
            metrics = {"ce": loss, "aux": torch.zeros((), device=self.device)}
        else:
            loss, metrics = self._loss(batch)
        grads = self._grads
        if self.tcfg.compress_grads:
            grads, comp, cm = compress_gradients(grads, comp)
            metrics = {**metrics, **cm}
        params, opt, om = adamw_update(grads, opt, params, self.opt_cfg)
        return params, opt, comp, {"loss": loss, **metrics, **om}

    # ------------------------------------------------------------------
    def _init_state(self):
        """Fresh (params, optimizer state, compression state): the weights
        drawn from a generator on the device seeded by ``tcfg.seed``."""
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = self.model.init(gen)
        opt = adamw_init(params)
        comp = compression_init(params) if self.tcfg.compress_grads else \
            CompressionState(residual=torch.zeros((), device=self.device))
        return params, opt, comp

    def _restore_or_init(self, mgr: Optional[CheckpointManager]):
        params, opt, comp = self._init_state()
        params = as_tree(params)
        if self.mesh is not None:
            params, opt, comp = self._distribute(params, opt, comp)
        start = 0
        if mgr and latest_step(mgr.ckpt_dir) is not None:
            (params, opt, comp), step, extra = mgr.restore((params, opt, comp))
            start = int(extra.get("data_step", step))
            self.log(f"[trainer] restored checkpoint step={step}")
        self._bind(params)
        return params, opt, comp, start

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        tcfg = self.tcfg
        mgr = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep,
                                 async_save=tcfg.async_ckpt, mesh=self.mesh)
               if tcfg.ckpt_dir else None)
        params, opt, comp, start = self._restore_or_init(mgr)
        self.ds.state.step = start
        step = start
        injected = False

        while step < tcfg.steps:
            try:
                batch = next(self.ds)
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch.items()}
                if (tcfg.inject_failure_at is not None
                        and step == tcfg.inject_failure_at and not injected):
                    injected = True
                    raise _InjectedFailure(f"injected fault at step {step}")
                t0 = time.time()
                params, opt, comp, metrics = self._train_step(
                    params, opt, comp, batch)
                self.state = (params, opt, comp)    # the state after it
                names = sorted(metrics)
                values = torch.stack([metrics[k].float() for k in names])
                values = dict(zip(names, values.tolist()))   # one read
                loss = values["loss"]
                dt = time.time() - t0
                for d in self.monitor.update(dt):
                    self.log(f"[straggler] step={d.step} rank={d.rank} "
                             f"ratio={d.ratio:.2f} action={d.action}")
                self.history.append({"step": step, "loss": loss, "dt": dt})
                self.metrics.append({"step": step, **values})
                if step % tcfg.log_every == 0:
                    self.log(f"[trainer] step={step} loss={loss:.4f} "
                             f"({dt*1000:.0f} ms)")
                step += 1
                self.ds.state.step = step
                if mgr and step % tcfg.ckpt_every == 0:
                    mgr.save(step, (params, opt, comp),
                             extra={"data_step": step})
            except _InjectedFailure as e:
                self.log(f"[trainer] FAILURE: {e}; restarting from checkpoint")
                self.restarts += 1
                if self.restarts > tcfg.max_restarts:
                    raise
                if mgr:
                    mgr.wait()
                params, opt, comp, step = self._restore_or_init(mgr)
                self.ds.state.step = step

        if mgr:
            mgr.save(step, (params, opt, comp), extra={"data_step": step})
            mgr.wait()
        self.state = (params, opt, comp)
        return {
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "history": self.history,
            "restarts": self.restarts,
            "straggler": self.monitor.summary(),
        }
