"""The sharded layout (DTensor over a ``("data", "model")`` mesh) on the
CPU: gloo worlds of 2 x 1 (FSDP), 1 x 2 (tensor parallel) and 2 x 2
spawned ranks (``repro_torch.launch.spawn_world``, bounded by
``WORLD_LIMIT`` seconds).  One world a mesh shape runs every case on
every rank (``tests/_torch_shard_worker.py``) and rank 0 returns the
results, which are held here against the ``mesh=None`` port, run once in
this process, and against the JAX package:

- each family's loss and every gradient, gathered, against ``mesh=None``
  and against ``jax.value_and_grad(model.loss_fn)`` on the same weights
  and batch: loss within rtol 1e-5, gradients within atol 1e-5 + rtol
  1e-4 (as ``tests/test_torch_train.py`` holds the port to JAX);
- a 6-step ``Trainer`` run (2 microbatches, int8 compression, a fault at
  step 3 rolled back to the step-2 checkpoint): the steps and restarts of
  the ``mesh=None`` run, every metric within rtol 1e-4 (the learning rate
  1e-6), the replayed step bit for bit, the parameters within atol
  ``PARAM_ATOL`` (AdamW moves each weight by about its learning rate a
  step, whatever the gradient's size, so a rounding-level difference in a
  near-zero gradient may move a weight the other way);
- the mesh run's last checkpoint, restored by a one-device trainer,
  equal to the mesh run's final parameters;
- ``prefill`` and greedy ``decode_step``s of each family (``use_pallas``
  set: attention on each rank's local heads) under one serving rule set
  a mesh shape (``PREFILL_RULES``, ``SERVE_RULES``, ``LONG_DECODE_RULES``),
  against ``mesh=None``: logits within 1e-5, tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_shard_worker as w
from repro.configs.base import get_config as jax_get_config
from repro.models.api import get_model as jax_get_model
from repro_torch.launch import spawn_world
from repro_torch.tree import tree_items

WORLD_LIMIT = 300.0     # seconds a world may take, spawning included
GROUP_TIMEOUT = 60.0    # the gloo group's collective timeout
WORLDS = {"2x1": ((2, 1), "prefill_seq_unsharded"),
          "1x2": ((1, 2), "serve_2d_stationary"),
          "2x2": ((2, 2), "long_decode_seqshard")}
PARAM_ATOL = w.OPT["lr"]
STEP_KEYS = ("loss", "ce", "grad_norm", "ef_l1")


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request):
    shape, rules = WORLDS[request.param]
    out = spawn_world(w.world_checks, shape[0] * shape[1],
                      args=(shape, rules), device_type="cpu",
                      timeout=WORLD_LIMIT, group_timeout=GROUP_TIMEOUT)[0]
    return request.param, out


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """The port's ``mesh=None`` results, once for every world."""
    torch.set_num_threads(1)
    return {"grads": {a: w.loss_and_grads(a, None) for a in w.ARCHS},
            "train": w.train_run(None, str(tmp_path_factory.mktemp("one"))),
            "serve": {a: w.serve_run(a, None, None) for a in w.ARCHS}}


@pytest.fixture(scope="module")
def jax_grads():
    out = {}
    for arch in w.ARCHS:
        batch = {k: jnp.asarray(v) for k, v in w.inputs(arch).items()}
        (loss, _), grads = jax.value_and_grad(
            jax_get_model(jax_get_config(arch).reduced()).loss_fn,
            has_aux=True)(jax.tree.map(jnp.asarray, w.weights(arch)), batch)
        out[arch] = float(loss), dict(tree_items(
            jax.tree.map(np.asarray, grads)))
    return out


def _close_grads(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("arch", w.ARCHS)
def test_loss_and_grads_match_mesh_none(world, one_device, arch):
    loss, grads = world[1]["grads"][arch]
    want_loss, want = one_device["grads"][arch]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _close_grads(grads, want)


@pytest.mark.parametrize("arch", w.ARCHS)
def test_loss_and_grads_match_jax(world, jax_grads, arch):
    loss, grads = world[1]["grads"][arch]
    want_loss, want = jax_grads[arch]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _close_grads(grads, want)


def test_trainer_matches_mesh_none(world, one_device):
    got, want = world[1]["train"], one_device["train"]
    assert got["steps"] == want["steps"] == [0, 1, 2, 2, 3, 4, 5]
    assert got["restarts"] == want["restarts"] == 1
    for a, b in zip(got["metrics"], want["metrics"]):
        for k in STEP_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                       err_msg=f"step {a['step']} {k}")
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_fault_replays_bit_for_bit(world):
    """Step 2 ran, the fault at step 3 rolled back to the step-2
    checkpoint, and step 2 ran again: the same metrics, bit for bit."""
    m = world[1]["train"]["metrics"]
    assert m[2]["step"] == m[3]["step"] == 2
    assert m[2] == m[3]


def test_checkpoint_restores_on_one_device(world):
    params, step = world[1]["restored"]
    assert step == w.TCFG["steps"]
    got = world[1]["train"]["params"]
    assert sorted(params) == sorted(got)
    for k in got:
        np.testing.assert_array_equal(params[k], got[k], err_msg=k)


@pytest.mark.parametrize("arch", w.ARCHS)
def test_serving_matches_mesh_none(world, one_device, arch):
    logits, tokens = world[1]["serve"][arch]
    want_logits, want_tokens = one_device["serve"][arch]
    assert tokens == want_tokens
    assert len(logits) == len(want_logits) == w.GEN + 1
    for a, b in zip(logits, want_logits):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
