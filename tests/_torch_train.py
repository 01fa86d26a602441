"""Shared by the training tests: the JAX package's ``Trainer`` and the
port's on the same seeded numpy weights and token stream.

Both trainers' ``_init_state`` is replaced by one that returns the numpy
tree of :func:`weights` (fresh arrays on every call, as a restart needs),
with zero moments and residuals: the one seam through which the two see the
same model.  Each run returns one dict a step executed, in order (replayed
steps again): ``step`` and the step's ``loss``, ``ce``, ``grad_norm`` and
``lr`` (the JAX step function's metrics, read by wrapping it).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.compression import CompressionState as JaxCompressionState
from repro.optim.compression import compression_init as jax_compression_init
from repro.runtime.trainer import Trainer as JaxTrainer
from repro.runtime.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.optim import (
    AdamWConfig, CompressionState, adamw_init, compression_init,
)
from repro_torch.runtime.trainer import Trainer, TrainerConfig

KEYS = ("loss", "ce", "grad_norm", "lr")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module of tiny models: with the suite's
    other workers busy, torch's thread pool spins against them and a
    trainer run takes several times as long as with one thread (alone the
    two take the same time).  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LIVE_SEED = 3      # see test_torch_train.py::test_rwkv_grads_at_an_ill_conditioned_point


def configs(arch, **over):
    """(JAX config, port config) of a reduced arch."""
    return (jax_get_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def weights(arch, seed=0):
    """Seeded numpy weights: rwkv's zero-init leaves drawn live (from
    ``LIVE_SEED``), dense
    attention at its true fan-in (``scale_attention_fan_in``: the
    reference's init makes a random dense model chaotic, and eight training
    steps then part two f32 implementations by ~1e-4)."""
    _, cfg = configs(arch)
    rwkv = cfg.family == "rwkv"
    return numpy_lm_params(cfg, seed, live_seed=LIVE_SEED if rwkv else None,
                           fan_in=not rwkv)


def _steps(history, metrics):
    return [{"step": h["step"], **{k: float(m[k]) for k in KEYS}}
            for h, m in zip(history, metrics)]


def run_jax(arch, tree, opt, tcfg, data, **over):
    """The JAX package's trainer.  ``opt``/``tcfg``: dicts of
    ``AdamWConfig``/``TrainerConfig`` fields; ``data``: ``(batch, seq,
    seed)``; ``over``: config overrides.  Returns (steps, result)."""
    jcfg, _ = configs(arch, **over)
    compress = tcfg.get("compress_grads", False)
    with tempfile.TemporaryDirectory() as d:
        tr = JaxTrainer(jcfg, JaxAdamWConfig(**opt), JaxTrainerConfig(
            ckpt_dir=d, log_every=10**9, **tcfg),
            JaxTokens(jcfg.vocab, *data[:2], seed=data[2]),
            log=lambda *_: None)

        def init_state():
            p = jax.tree.map(jnp.asarray, tree)
            return p, jax_adamw_init(p), (
                jax_compression_init(p) if compress
                else JaxCompressionState(residual=jnp.zeros(())))

        step_fn, seen = tr._step_fn, []

        def recording(*args):
            out = step_fn(*args)
            seen.append(out[3])
            return out

        tr._init_state, tr._step_fn = init_state, recording
        res = tr.run()
    return _steps(res["history"], seen), res


def port_trainer(arch, tree, opt, tcfg, data, ckpt_dir, device="cpu",
                 **over):
    """The port's trainer on ``device``, its ``_init_state`` patched."""
    _, cfg = configs(arch, **over)
    compress = tcfg.get("compress_grads", False)
    tr = Trainer(cfg, AdamWConfig(**opt), TrainerConfig(
        ckpt_dir=ckpt_dir, log_every=10**9, **tcfg),
        SyntheticTokens(cfg.vocab, *data[:2], seed=data[2]),
        log=lambda *_: None, device=device)

    def init_state():
        p = lm_params_from_numpy(tree, device)
        return p, adamw_init(p), (
            compression_init(p) if compress
            else CompressionState(residual=torch.zeros((), device=device)))

    tr._init_state = init_state
    return tr


def run_port(arch, tree, opt, tcfg, data, device="cpu", **over):
    """The port's trainer; returns (steps, result, trainer)."""
    with tempfile.TemporaryDirectory() as d:
        tr = port_trainer(arch, tree, opt, tcfg, data, d, device, **over)
        res = tr.run()
    return _steps(res["history"], tr.metrics), res, tr


def close(port_steps, jax_steps, rtol, grad_rtol=None, lr_rtol=1e-6):
    """Losses and ce within ``rtol``, grad norms within ``grad_rtol``
    (default ``rtol``), lr within f32 rounding, step for step."""
    assert [s["step"] for s in port_steps] == [s["step"] for s in jax_steps]
    for k, tol in (("loss", rtol), ("ce", rtol),
                   ("grad_norm", grad_rtol or rtol), ("lr", lr_rtol)):
        np.testing.assert_allclose([s[k] for s in port_steps],
                                   [s[k] for s in jax_steps], rtol=tol,
                                   err_msg=k)
