"""The port's vlm LM (qwen2-vl-72b) against the JAX package's, on the CPU.

Reduced qwen2-vl-72b: 4 layers, d_model 128, 4 heads of 32 over 4 KV
heads, f32; a request of S positions is ``int(S / 4)`` patch embeddings
(projected by ``frontend_proj``) in front of the text's tokens.  Weights
are the seeded numpy trees of ``_torch_lm.weights`` with the attention at
its true fan-in (the reference's initializer makes a random model chaotic,
tests/test_torch_lm.py).  Tolerances as tests/test_torch_lm.py states
them: logits atol = rtol = 5e-4, K/V caches a max-norm relative error of
5e-4, generated tokens equal; the loss within rtol 1e-5 and every gradient
within atol 1e-5 + rtol 1e-4 of ``jax.value_and_grad(loss_fn)``.

The prefill's K/V cover the patches' positions and the text's, and
decoding goes on at the position after them.  The JAX ``serve_batch``
never draws patches, so the port's tokens are held to the JAX ``prefill``
with the patches followed by its ``decode_step``
(``_torch_lm.jax_prefill_decode``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as tl
from repro.models import lm as jax_lm
from repro.models.api import get_model as jax_get_model
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import request_inputs, serve_batch
from repro_torch.models import lm
from repro_torch.models.api import get_model
from repro_torch.sharding.rules import map_defs, shapes_from_defs
from repro_torch.tree import tree_items

ARCH = "qwen2-vl-72b"
TOL = 5e-4
B, N_FRONT, T = 2, 9, 20
REMAT = [None, "nothing", "dots"]

_PARAMS = {}


def _params():
    """(JAX params, the port's copy of them), fan-in weights."""
    if not _PARAMS:
        tree = tl.weights(ARCH, fan_in=True)
        _PARAMS["p"] = (jax.tree.map(jnp.asarray, tree),
                        lm_params_from_numpy(tree, "cpu"))
    return _PARAMS["p"]


def _batch(cfg, seed=1, n_front=N_FRONT, t=T):
    rng = np.random.default_rng(seed)
    return {"patches": rng.standard_normal((B, n_front, cfg.d_model),
                                           dtype=np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, t)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(port, jax_out, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


def _close_cache(port, jax_out):
    want = np.asarray(jax_out, np.float32)
    assert tuple(port.shape) == want.shape
    err = np.abs(port.float().numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_param_and_cache_defs_match_jax():
    jcfg, cfg = tl.configs(ARCH)
    jm, m = jax_get_model(jcfg), get_model(cfg)
    is_def = lambda x: hasattr(x, "axes")  # noqa: E731
    assert map_defs(lambda d: (d.shape, d.axes, d.init, d.scale),
                    m.param_defs) == jax.tree.map(
        lambda d: (d.shape, d.axes, d.init, d.scale), jm.param_defs,
        is_leaf=is_def)
    assert m.n_params() == jm.n_params()
    assert jax.tree.map(lambda t: tuple(t.shape),
                        shapes_from_defs(m.param_defs)) == jax.tree.map(
        lambda t: t.shape, jm.param_shapes())
    for seq in (16, 200):
        assert map_defs(lambda d: (d.shape, d.axes),
                        m.cache_defs_fn(3, seq)) == jax.tree.map(
            lambda d: (d.shape, d.axes), jm.cache_defs_fn(3, seq),
            is_leaf=is_def)
    # the port's LM holds frontend_proj, a leaf, beside the subtrees
    jp, params = _params()
    flat = {".".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    sd = params.state_dict()
    assert sorted(sd) == sorted(flat) and "frontend_proj" in sd
    for k, t in sd.items():
        assert tuple(t.shape) == flat[k].shape and t.dtype == torch.float32
    assert [k for k, _ in params.items()] == list(params.tree())


def test_full_width_parameter_counts():
    """The sizes chip_smoke.py's layer cut rests on: 877,674,496 parameters
    a layer (3.511 GB in f32) and 1,312,555,008 in the tied embedding and
    ``frontend_proj`` (5.25 GB)."""
    full = get_model(get_config(ARCH))
    assert full.n_params() == jax_get_model(
        tl.jax_get_config(ARCH)).n_params()
    one, two = (get_model(dataclasses.replace(get_config(ARCH), n_layers=n))
                for n in (1, 2))
    layer = two.n_params() - one.n_params()
    assert layer == 877_674_496
    assert one.n_params() - layer == 152_064 * 8192 + 8192 ** 2 + 8192
    assert full.n_params() == 80 * layer + one.n_params() - layer


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_match_jax(use_pallas):
    """The text positions' logits, the patches in front."""
    jcfg, cfg = tl.configs(ARCH, use_pallas=use_pallas)
    jp, params = _params()
    batch = _batch(cfg)
    want, _, _ = jax_lm.forward(jp, _jax(batch), jcfg)
    got, cache = lm.forward(params, _torch(batch), cfg)
    assert cache is None and got.shape == (B, T, cfg.vocab)
    _close(got, want)


def test_forward_without_patches_matches_jax():
    """A batch without patches is a dense model over the text."""
    jcfg, cfg = tl.configs(ARCH)
    jp, params = _params()
    batch = {"tokens": _batch(cfg)["tokens"]}
    want, _, _ = jax_lm.forward(jp, _jax(batch), jcfg)
    got, _ = lm.forward(params, _torch(batch), cfg)
    _close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_jax(use_pallas):
    """Last-position logits and the K/V of every position, the patches'
    first."""
    jcfg, cfg = tl.configs(ARCH, use_pallas=use_pallas)
    jp, params = _params()
    batch = _batch(cfg, seed=2)
    want, wcache = jax_lm.prefill(jp, _jax(batch), jcfg)
    got, cache = get_model(cfg).prefill(params, _torch(batch))
    _close(got, want)
    for n in ("k", "v"):
        assert cache[n].shape[2] == N_FRONT + T
        _close_cache(cache[n], wcache[n])


def test_decode_step_matches_jax():
    """Two decode steps at the positions after the patches and the text,
    from the JAX prefill's K/V: logits and the whole cache."""
    jcfg, cfg = tl.configs(ARCH)
    jp, params = _params()
    batch = _batch(cfg, seed=3)
    _, jcache = jax_lm.prefill(jp, _jax(batch), jcfg)
    P = N_FRONT + T
    start = {n: np.pad(np.asarray(jcache[n]),
                       [(0, 0), (0, 0), (0, 2), (0, 0), (0, 0)])
             for n in ("k", "v")}
    jc, tc = jax.tree.map(jnp.asarray, start), tl.torch_tree(start)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, B)).astype(
        np.int32)
    for step, tok in enumerate(toks):
        want, jc = jax_lm.decode_step(jp, jnp.asarray(tok),
                                      jnp.int32(P + step), jc, jcfg)
        got, tc = lm.decode_step(params, torch.from_numpy(tok), P + step, tc,
                                 cfg)
        _close(got, want)
        for n in ("k", "v"):
            _close_cache(tc[n], jc[n])


def test_decode_matches_forward():
    """Prefilling the patches and the first text token, then decoding the
    rest token by token at the positions after the patches, gives the full
    forward's logits at every text position."""
    _, cfg = tl.configs(ARCH)
    _, params = _params()
    batch = _torch(_batch(cfg, seed=6))
    full, _ = lm.forward(params, batch, cfg)
    first, kv = lm.prefill(params, {"patches": batch["patches"],
                                    "tokens": batch["tokens"][:, :1]}, cfg)
    np.testing.assert_allclose(first.numpy(), full[:, 0].numpy(), atol=TOL,
                               rtol=TOL)
    cache = map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                     lm.cache_defs(cfg, B, N_FRONT + T))
    for n in ("k", "v"):
        cache[n][:, :, :N_FRONT + 1] = kv[n]
    for t in range(1, T):
        got, cache = lm.decode_step(params, batch["tokens"][:, t],
                                    N_FRONT + t, cache, cfg)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(), atol=TOL,
                                   rtol=TOL)


@pytest.fixture(scope="module")
def jax_grads():
    jcfg, cfg = tl.configs(ARCH)
    batch = _batch(cfg, seed=5, t=41)
    batch = {"patches": batch["patches"], "tokens": batch["tokens"][:, :-1],
             "labels": batch["tokens"][:, 1:]}
    (loss, aux), grads = jax.value_and_grad(
        jax_get_model(jcfg).loss_fn, has_aux=True)(_params()[0], _jax(batch))
    return batch, float(loss), dict(tree_items(
        jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("remat", REMAT)
def test_loss_and_grads_match_jax(remat, jax_grads):
    """The loss over the text labels, and every gradient, ``frontend_proj``
    included."""
    batch, want_loss, want = jax_grads
    over = {} if remat is None else {"remat": True, "remat_policy": remat}
    _, cfg = tl.configs(ARCH, **over)
    params = lm_params_from_numpy(tl.weights(ARCH, fan_in=True),
                                  "cpu").requires_grad_(True)
    loss, _ = get_model(cfg).loss_fn(params, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    got = {k: t.grad.numpy() for k, t in tree_items(params.tree())}
    assert sorted(got) == sorted(want)
    assert np.abs(got["frontend_proj"]).max() > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_request_inputs_split_as_the_input_specs():
    """A request of S positions: int(S * frontend_frac) patches and S -
    that text tokens, the patches drawn after the tokens."""
    _, cfg = tl.configs(ARCH)
    got = request_inputs(cfg, B, 2048, 0)
    assert got["tokens"].shape == (B, 1536) and got["patches"].shape == (
        B, 512, cfg.d_model)
    got, want = request_inputs(cfg, B, 41, 3), tl.jax_inputs(cfg, B, 41, 3)
    assert sorted(got) == sorted(want) and want["patches"].shape[1] == 10
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("S,gen,use_pallas", [(40, 8, True), (41, 6, False),
                                              (3, 4, True)])
def test_serve_batch_tokens_match_jax(S, gen, use_pallas):
    """The port's request path against the JAX ``prefill`` with the
    patches followed by its ``decode_step`` at the positions after them
    (S = 3 takes no patch)."""
    jcfg, cfg = tl.configs(ARCH, use_pallas=use_pallas)
    jp, params = _params()
    inputs = tl.jax_inputs(cfg, B, S, 0)
    want = tl.jax_prefill_decode(jcfg, jp, inputs["tokens"], gen,
                                 inputs.get("patches"))
    got, stats = serve_batch(cfg, B, S, gen, seed=0, params=params,
                             device="cpu")
    assert got.dtype == torch.int32
    assert got.shape == (B, inputs["tokens"].shape[1] + gen)
    np.testing.assert_array_equal(got.numpy(), want)
