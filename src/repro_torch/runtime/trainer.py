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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.ckpt.store import CheckpointManager, latest_step
from repro_torch.configs.base import ModelConfig
from repro_torch.core.jobs import resolve_device
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import (
    CompressionState, compress_gradients, compression_init,
)
from repro_torch.runtime.straggler import StragglerMonitor
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


def _trainable_view(params, grads):
    """The leaves autograd differentiates: each leaf of ``params`` detached
    (sharing its storage) with its ``grads`` buffer as ``.grad``, and each
    stacked leaf under ``blocks`` as a list of such per-layer leaves."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    return {k: tree_map(
        (lambda p, g: [leaf(p[i], g[i]) for i in range(p.shape[0])])
        if k == "blocks" else leaf, x, grads[k])
        for k, x in params.items()}


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainerConfig, dataset, *, mesh=None, rules=None,
                 log: Callable[[str], None] = print, device=None):
        """``device`` defaults to cuda and raises without a card; CPU
        callers pass ``device="cpu"``.  ``rules`` (the logical-axis
        sharding rules) are ignored on one device."""
        if mesh is not None:
            raise NotImplementedError(
                "the port trains on one device; a mesh waits for the "
                "sharded layout (ROADMAP Queue 1 item 10(f))")
        del rules
        self.device = resolve_device(device)
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
        self._view = _trainable_view(params, self._grads)

    def _train_step(self, params, opt, comp, batch):
        for g in tree_leaves(self._grads):
            g.zero_()
        accum = self.tcfg.accum
        if accum > 1:
            ces = []
            for i in range(accum):
                mb = {k: x.reshape((accum, -1) + x.shape[1:])[i]
                      for k, x in batch.items()}
                loss, m = self.model.loss_fn(self._view, mb)
                loss.backward()
                ces.append(m["ce"].detach())
            n = torch.tensor(float(accum), device=self.device)
            for g in tree_leaves(self._grads):
                g.div_(n)
            loss = torch.stack(ces).mean()
            metrics = {"ce": loss, "aux": torch.zeros((), device=self.device)}
        else:
            loss, m = self.model.loss_fn(self._view, batch)
            loss.backward()
            loss, metrics = loss.detach(), {k: x.detach() for k, x in m.items()}
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
                                 async_save=tcfg.async_ckpt)
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
