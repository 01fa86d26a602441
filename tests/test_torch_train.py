"""The port's training side against the JAX package's, on the CPU.

Reduced configs (4 layers, d_model 128, vocab 512, f32).  Weights are the
seeded numpy trees of ``_torch_train.weights``: rwkv's zero-init leaves
drawn live, dense attention at its true fan-in (the reference's
initializer makes a random dense model chaotic: with it the two packages'
gradients part by up to 1.2e-3 of a leaf's largest entry, with it scaled
by under 1e-7; ``test_reference_init_loss_matches_jax`` holds the loss on the
reference's own init).

Tolerances: the loss within rtol 1e-5 and every leaf's gradient within
atol 1e-5 + rtol 1e-4 of ``jax.value_and_grad(model.loss_fn)``, with and
without per-layer remat.  A whole ``Trainer`` run (losses, ce and grad
norms) within rtol 1e-4 of the JAX ``Trainer``'s, the learning rate within
1e-6; the compressed run's grad norms within 1e-2 (int8 rounding is
discontinuous: an element within an ulp of a rounding boundary in one
package and across it in the other moves an Adam update by a whole
quantum; the losses stay within 1e-4).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as tt
from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro.models import layers as jax_layers
from repro.models.api import get_model as jax_get_model
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.linattn_scan.ops import linattn
from repro_torch.models import layers
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_items

ARCHS = ["llama3.2-3b", "rwkv6-7b"]
REMAT = [None, "nothing", "dots"]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)
DATA = (4, 32, 1)                 # batch, seq, data seed


def _batch(cfg, seed=0, shape=(2, 41)):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _over(remat):
    return {} if remat is None else {"remat": True, "remat_policy": remat}


def _jax_value_and_grad(arch, tree, batch, **over):
    jcfg, _ = tt.configs(arch, **over)
    (loss, aux), grads = jax.value_and_grad(
        jax_get_model(jcfg).loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), float(aux["ce"]), dict(tree_items(
        jax.tree.map(np.asarray, grads)))


def _port_value_and_grad(arch, tree, batch, **over):
    _, cfg = tt.configs(arch, **over)
    params = lm_params_from_numpy(tree, "cpu").requires_grad_(True)
    loss, aux = get_model(cfg).loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), float(aux["ce"].detach()), {
        k: t.grad.numpy() for k, t in tree_items(params.tree())}


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's loss and gradients per arch (remat changes
    neither, so one JAX evaluation serves every remat setting)."""
    return {arch: _jax_value_and_grad(arch, tt.weights(arch),
                                      _batch(tt.configs(arch)[1]))
            for arch in ARCHS}


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat, jax_grads):
    want_loss, want_ce, want = jax_grads[arch]
    loss, ce, got = _port_value_and_grad(arch, tt.weights(arch),
                                         _batch(tt.configs(arch)[1]),
                                         **_over(remat))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert ce == loss
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_remat_with_jax_remat_matches():
    """remat on both sides (the JAX package checkpoints its scan body)."""
    arch = "llama3.2-3b"
    tree, batch = tt.weights(arch), _batch(tt.configs(arch)[1], seed=3)
    want_loss, _, want = _jax_value_and_grad(arch, tree, batch,
                                             **_over("dots"))
    loss, _, got = _port_value_and_grad(arch, tree, batch, **_over("dots"))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_reference_init_loss_matches_jax():
    """On the reference's own (chaotic) dense init the loss still agrees
    within 1e-5; its gradients part by up to 1.2e-3 of a leaf's largest
    entry, which is why the gradient tests scale the attention."""
    from repro_torch.convert import numpy_lm_params
    arch = "llama3.2-3b"
    _, cfg = tt.configs(arch)
    tree, batch = numpy_lm_params(cfg, 0), _batch(cfg)
    want_loss, _, want = _jax_value_and_grad(arch, tree, batch)
    loss, _, got = _port_value_and_grad(arch, tree, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 2e-3 * np.abs(want[k]).max()


def test_rwkv_grads_at_an_ill_conditioned_point():
    """rwkv with live leaves from seed 7 on the first synthetic batch: the
    loss agrees within 1e-6, but the gradient is ill-conditioned in f32
    there and the two packages' leaves part by ~5e-4 of their norm (the
    synthetic token stream repeats tokens; a random model meets such
    points now and then).  The trainer tests draw live leaves from seed 3,
    whose first steps are well conditioned."""
    from repro_torch.convert import numpy_lm_params
    arch = "rwkv6-7b"
    _, cfg = tt.configs(arch)
    tree = numpy_lm_params(cfg, 0, live_seed=7)
    batch = SyntheticTokens(cfg.vocab, 4, 32, seed=1).batch_at(0)
    want_loss, _, want = _jax_value_and_grad(arch, tree, batch)
    loss, _, got = _port_value_and_grad(arch, tree, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    gaps = [np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
            for k in want]
    assert max(gaps) < 2e-3


@pytest.mark.parametrize("S,chunk", [(40, 16), (33, 1024), (48, 16)])
def test_chunked_lm_loss_matches_jax(S, chunk):
    """Padding to a chunk multiple with label -1 (40 -> 48), one chunk
    shorter than the default, labels of -1 in the input: the value and the
    gradients with respect to the hidden states and the embedding."""
    jcfg, cfg = tt.configs("llama3.2-3b")
    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    labels[0, :3] = -1
    tok = (rng.standard_normal((cfg.vocab, cfg.d_model)) * 0.1).astype(
        np.float32)
    want, (gh, gtok) = jax.value_and_grad(
        lambda h, t: jax_layers.chunked_lm_loss(
            {"tok": t}, h, jnp.asarray(labels), jcfg, chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(tok))
    th = torch.from_numpy(h).requires_grad_()
    tt_ = torch.from_numpy(tok).requires_grad_()
    got = layers.chunked_lm_loss({"tok": tt_}, th, torch.from_numpy(labels),
                                 cfg, chunk=chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), atol=1e-7,
                               rtol=1e-5)
    np.testing.assert_allclose(tt_.grad.numpy(), np.asarray(gtok), atol=1e-7,
                               rtol=1e-5)
    full = layers.cross_entropy(
        layers.logits_from_hidden({"tok": torch.from_numpy(tok)},
                                  torch.from_numpy(h), cfg),
        torch.from_numpy(np.maximum(labels, 0)),
        torch.from_numpy((labels >= 0).astype(np.float32)))
    np.testing.assert_allclose(float(got.detach()), float(full), rtol=1e-5)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = jax_layers.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = layers.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_use_pallas_with_grad_raises_on_both():
    """Neither package differentiates its attention kernel: the JAX
    package's Pallas kernel fails an assertion under jax.grad, the port's
    op raises.  (JAX's rwkv model never routes the time-mix to its kernel;
    the port's does, so the port's rwkv raises as well.)"""
    for arch in ARCHS:
        _, cfg = tt.configs(arch, use_pallas=True)
        params = lm_params_from_numpy(tt.weights(arch), "cpu")
        params.requires_grad_(True)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        with pytest.raises(RuntimeError, match="no backward pass"):
            get_model(cfg).loss_fn(params, batch)
    jcfg, _ = tt.configs("llama3.2-3b", use_pallas=True)
    with pytest.raises(AssertionError):
        jax.grad(lambda p: jax_get_model(jcfg).loss_fn(
            p, {k: jnp.asarray(v) for k, v in _batch(jcfg).items()})[0])(
            jax.tree.map(jnp.asarray, tt.weights("llama3.2-3b")))


def test_kernel_ops_refuse_grad_and_serve_without():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 32)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 1, 32)).astype(
        np.float32))
    r = torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(
        np.float32))
    w = -torch.rand(1, 2, 8, 16)
    u = torch.zeros(2, 16)
    with pytest.raises(RuntimeError, match="no backward pass"):
        flash_attention(q.requires_grad_(), k, k)
    with pytest.raises(RuntimeError, match="no backward pass"):
        linattn(r, r, r, w, u.requires_grad_())
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == q.shape
        assert linattn(r, r, r, w, u).shape == r.shape


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer per arch: dense with remat ("dots") and a
    checkpoint every 3 steps; rwkv with compression."""
    return {arch: tt.run_jax(arch, tt.weights(arch), OPT, _trainer(arch),
                             DATA, **_trainer_over(arch))[0]
            for arch in ARCHS}


def _trainer(arch):
    return (dict(steps=6, ckpt_every=3) if arch == "llama3.2-3b"
            else dict(steps=6, ckpt_every=3, compress_grads=True))


def _trainer_over(arch):
    return _over("dots") if arch == "llama3.2-3b" else {}


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_jax(arch, jax_runs):
    got, res, _ = tt.run_port(arch, tt.weights(arch), OPT, _trainer(arch),
                              DATA, **_trainer_over(arch))
    want = jax_runs[arch]
    assert res["restarts"] == 0 and len(got) == 6
    compressed = _trainer(arch).get("compress_grads", False)
    tt.close(got, want, rtol=1e-4, grad_rtol=1e-2 if compressed else None)


def _port_run(tmp_path, name, **kw):
    _, cfg = tt.configs("llama3.2-3b")
    tcfg = TrainerConfig(steps=12, ckpt_dir=str(tmp_path / name),
                         ckpt_every=4, log_every=10**9, **kw)
    tr = Trainer(cfg, AdamWConfig(lr=1e-3, total_steps=12), tcfg,
                 SyntheticTokens(cfg.vocab, batch=4, seq=32, seed=1),
                 log=lambda *_: None, device="cpu")
    return tr.run(), tr


def test_failure_recovery_is_bit_deterministic(tmp_path):
    """Fault at step 6 -> restart from step 4 -> identical history."""
    clean, _ = _port_run(tmp_path, "clean")
    faulty, tr = _port_run(tmp_path, "faulty", inject_failure_at=6)
    assert faulty["restarts"] == 1
    steps = [h["step"] for h in faulty["history"]]
    assert steps == list(range(6)) + list(range(4, 12))
    a = {h["step"]: h["loss"] for h in clean["history"]}
    b = {h["step"]: h["loss"] for h in faulty["history"]}
    assert a == b
    assert clean["final_loss"] < clean["history"][0]["loss"]
    assert sorted(os.listdir(tmp_path / "faulty")) == ["step_12", "step_8"]


def test_grad_accum_matches_full_batch():
    """accum=4 microbatching equals the full-batch step."""
    _, cfg = tt.configs("llama3.2-3b")

    def run(accum):
        tr = Trainer(cfg, AdamWConfig(lr=1e-3), TrainerConfig(
            steps=2, log_every=10**9, accum=accum),
            SyntheticTokens(cfg.vocab, batch=8, seq=16, seed=2),
            log=lambda *_: None, device="cpu")
        return tr.run()["final_loss"]

    np.testing.assert_allclose(run(1), run(4), rtol=2e-4)


def test_trainer_defaults_to_cuda_and_refuses_a_mesh():
    _, cfg = tt.configs("llama3.2-3b")
    ds = SyntheticTokens(cfg.vocab, batch=2, seq=8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg, AdamWConfig(), TrainerConfig(), ds, mesh=object(),
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, AdamWConfig(), TrainerConfig(), ds)


def test_trainer_keeps_the_model_frozen_and_grads_in_its_buffers():
    """The trainer's parameters stay frozen leaves updated in place; the
    gradients land in one stacked buffer per leaf."""
    _, cfg = tt.configs("llama3.2-3b")
    tr = Trainer(cfg, AdamWConfig(lr=1e-3), TrainerConfig(
        steps=1, log_every=10**9), SyntheticTokens(cfg.vocab, 2, 16),
        log=lambda *_: None, device="cpu")
    tr.run()
    params, opt, _ = tr.state
    for (k, p), (_, g) in zip(tree_items(params), tree_items(tr._grads)):
        assert not p.requires_grad and g.shape == p.shape, k
        assert g.abs().sum() > 0, k
    wq = tr._view["blocks"]["attn"]["wq"]
    assert len(wq) == cfg.n_layers
    assert wq[1].grad.data_ptr() == tr._grads["blocks"]["attn"][
        "wq"][1].data_ptr()
    assert wq[1].data_ptr() == params["blocks"]["attn"]["wq"][1].data_ptr()
    assert int(opt.step) == 1


def test_launch_train_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = tmp_path / "out.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama3.2-3b", "--reduced", "--steps", "4", "--batch", "2",
           "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
           "--ckpt-every", "2", "--inject-failure-at", "3",
           "--out", str(out)]
    done = subprocess.run(cmd + ["--device", "cpu"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "restarts: 1" in done.stdout
    import json
    res = json.loads(out.read_text())
    assert [h["step"] for h in res["history"]] == [0, 1, 2, 2, 3]
    if not torch.cuda.is_available():
        done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=300)
        assert done.returncode != 0 and "no CUDA device" in done.stderr


def test_lm_leaves_train_through_requires_grad():
    """An LM is created frozen (serving edits leaves in place);
    ``requires_grad_()`` makes its leaves trainable, and serving still
    records no graph on them."""
    _, cfg = tt.configs("llama3.2-3b")
    params = get_model(cfg).init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in params.parameters())
    params.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, _ = get_model(cfg).loss_fn(params, batch)
    loss.backward()
    assert all(p.grad is not None for p in params.parameters())
    from repro_torch.models import lm
    logits, _ = lm.prefill(params, {"tokens": batch["tokens"]},
                           dataclasses.replace(cfg, use_pallas=True))
    assert not logits.requires_grad
