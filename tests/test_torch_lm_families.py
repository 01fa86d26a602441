"""The port's moe and hybrid LMs against the JAX package's, on the CPU.

Reduced mixtral-8x7b (4 layers, 4 experts top-2, window 64), reduced
llama4-scout-17b-a16e (4 experts top-1 plus a shared expert, QK norms)
and reduced zamba2-2.7b (2 groups of 2 Mamba2 layers, each followed by
the shared attention block), d_model 128, f32.  Weights are the seeded
numpy trees of ``_torch_lm.weights``: the QK norms and the Mamba2 leaves
that ``init`` leaves at zero or one drawn live.  Tolerances as
tests/test_torch_lm.py states them for the dense family: logits atol =
rtol = 5e-4, K/V caches and states a max-norm relative error of 5e-4,
generated tokens equal.

moe tokens are held to the JAX package's ``prefill`` followed by its
``decode_step`` (``_torch_lm.jax_prefill_decode``), the port's request
path; hybrid tokens to the JAX ``serve_batch``.  Losses and every gradient
as tests/test_torch_train.py holds the dense ones: the loss within rtol
1e-5 and each gradient within atol 1e-5 + rtol 1e-4 of
``jax.value_and_grad(loss_fn)``, with the attention at its true fan-in.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as tl
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import lm as jax_lm
from repro.models.api import get_model as jax_get_model
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import serve_batch
from repro_torch.models import lm, moe
from repro_torch.models.api import get_model
from repro_torch.sharding.rules import init_from_defs, map_defs, shapes_from_defs
from repro_torch.tree import tree_items

TOL = 5e-4
MOE = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
HYBRID = "zamba2-2.7b"
ARCHS = MOE + [HYBRID]
B, S = 2, 40
REMAT = [None, "nothing", "dots"]

_PARAMS = {}


def _params(arch):
    """(JAX params, the port's copy of them) from ``_torch_lm.weights``."""
    if arch not in _PARAMS:
        tree = tl.weights(arch)
        _PARAMS[arch] = (jax.tree.map(jnp.asarray, tree),
                         lm_params_from_numpy(tree, "cpu"))
    return _PARAMS[arch]


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


def _close(port, jax_out, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


def _close_cache(port, jax_out):
    want = np.asarray(jax_out, np.float32)
    assert tuple(port.shape) == want.shape
    err = np.abs(port.float().numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _jax_decode_cache(arch, toks):
    """The JAX package's decode cache after feeding ``toks`` [B, P] through
    its decode steps from zeros (its serve_batch's path), sized for P + 2
    positions, as numpy."""
    jcfg, _ = tl.configs(arch)
    jp, _ = _params(arch)
    model = jax_get_model(jcfg)
    Bb, P = toks.shape
    cache = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype),
                         model.cache_defs_fn(Bb, P + 2),
                         is_leaf=lambda x: hasattr(x, "axes"))
    step = jax.jit(model.decode_step)
    for p in range(P):
        _, cache = step(jp, jnp.asarray(toks[:, p]), jnp.int32(p), cache)
    return jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_defs_match_jax(arch):
    jcfg, cfg = tl.configs(arch)
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
    # the port's LM keeps the JAX tree's paths, shapes and dtypes
    jp, params = _params(arch)
    flat = {".".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    sd = params.state_dict()
    assert sorted(sd) == sorted(flat)
    for k, t in sd.items():
        assert tuple(t.shape) == flat[k].shape and t.dtype == torch.float32
    assert jax.tree.map(lambda t: tuple(t.shape), params.tree()) == \
        jax.tree.map(lambda a: a.shape, jp)


def test_full_width_parameter_counts():
    """The full configs' sizes that chip_smoke.py's layer cuts rest on."""
    from repro_torch.configs.base import get_config
    mix, scout, zamba = (get_model(get_config(a)) for a in ARCHS)
    assert mix.n_params() == 46_571_720_704
    assert scout.n_params() == 106_735_387_648
    assert zamba.n_params() == 2_340_612_000
    cut = get_model(dataclasses.replace(get_config("mixtral-8x7b"),
                                        n_layers=1))
    assert cut.n_params() - 32_000 * 4096 - 4096 == 1_451_270_144


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_is_randn_times_std(arch):
    """``init_from_defs`` scales each normal leaf in place (a stacked expert
    leaf is tens of GB at full width): the numbers are those of ``randn x
    std``, each leaf drawn after the last from one generator."""
    _, cfg = tl.configs(arch)
    defs = get_model(cfg).param_defs
    got = init_from_defs(defs, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)

    def leaf(d):
        if d.init in ("zeros", "ones"):
            return torch.full(d.shape, float(d.init == "ones"))
        return torch.randn(d.shape, generator=g) * d.std()

    want = map_defs(leaf, defs)
    for (k, t), (_, w) in zip(tree_items(got), tree_items(want)):
        assert torch.equal(t, w), k


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, cfg = tl.configs(arch)
    jp, params = _params(arch)
    toks = _tokens(cfg)
    want, _, _ = jax_lm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, cache = lm.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert cache is None and got.shape == (B, S, cfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, use_pallas):
    """Last-position logits and the K/V (a hybrid model's shared block's,
    one a group, under ``attn``)."""
    jcfg, cfg = tl.configs(arch, use_pallas=use_pallas)
    jp, params = _params(arch)
    toks = _tokens(cfg, seed=2)
    want, wcache = jax_lm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, cache = lm.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(got, want)
    kv = cache["attn"] if arch == HYBRID else cache
    for n in ("k", "v"):
        _close_cache(kv[n], wcache[n])


def test_hybrid_prefill_returns_the_decode_cache():
    """The port's hybrid prefill leaves each Mamba2 layer's final SSM state
    and conv tail: the state the JAX package's decode steps build from the
    same prompt, and its K/V are those the steps write."""
    _, cfg = tl.configs(HYBRID)
    _, params = _params(HYBRID)
    toks = _tokens(cfg, seed=7)
    _, cache = lm.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    want = _jax_decode_cache(HYBRID, toks)
    G, K = cfg.n_layers // cfg.attn_every, cfg.attn_every
    assert tuple(cache["ssm_state"].shape) == (
        G, K, B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    for n in ("ssm_state", "conv"):
        _close_cache(cache[n], want[n])
    for n in ("k", "v"):
        _close_cache(cache["attn"][n], want["attn"][n][:, :, :S])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """Two decode steps from the same cache: logits and the whole updated
    cache.  moe: the JAX prefill's K/V padded to the decode length;
    hybrid: the cache the JAX decode steps leave after the prompt."""
    jcfg, cfg = tl.configs(arch)
    jp, params = _params(arch)
    toks = _tokens(cfg, seed=3)
    if arch == HYBRID:
        start = _jax_decode_cache(arch, toks)
    else:
        _, jcache = jax_lm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
        C = min(S + 2, cfg.window or S + 2)
        start = {n: np.pad(np.asarray(jcache[n]),
                           [(0, 0), (0, 0), (0, C - S), (0, 0), (0, 0)])
                 for n in ("k", "v")}
    jc = jax.tree.map(jnp.asarray, start)
    tc = tl.torch_tree(start)
    for step, tok in enumerate(_tokens(cfg, seed=4, shape=(2, B))):
        pos = S + step
        want, jc = jax_lm.decode_step(jp, jnp.asarray(tok), jnp.int32(pos),
                                      jc, jcfg)
        got, tc = lm.decode_step(params, torch.from_numpy(tok), pos, tc, cfg)
        _close(got, want)
        want_cache = dict(tree_items(jc))
        for k, t in tree_items(tc):
            _close_cache(t, want_cache[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Decoding token by token from an empty cache gives the full forward's
    logits at every position.  moe runs at capacity factor 8, where the
    full sequence drops no slot: a decode step routes one token and never
    drops, so with drops the two are different functions (mixtral's 80
    positions also wrap its 64-slot ring)."""
    over = {"capacity_factor": 8.0} if arch in MOE else {}
    _, cfg = tl.configs(arch, **over)
    _, params = _params(arch)
    n = 80 if cfg.window else S
    toks = torch.from_numpy(_tokens(cfg, seed=6, shape=(B, n)))
    with moe.recording() as rec:
        full, _ = lm.forward(params, {"tokens": toks}, cfg)
    assert all(bool(r["kept"].all()) for r in rec)
    cache = map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                     lm.cache_defs(cfg, B, n))
    for pos in range(n):
        got, cache = lm.decode_step(params, toks[:, pos], pos, cache, cfg)
        np.testing.assert_allclose(got.numpy(), full[:, pos].numpy(),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,prompt_len,gen,use_pallas", [
    ("mixtral-8x7b", 80, 8, True),       # prompt past the 64 window
    ("mixtral-8x7b", 24, 8, False),
    ("llama4-scout-17b-a16e", 24, 8, True),
    ("zamba2-2.7b", 40, 8, True),
    ("zamba2-2.7b", 17, 6, False),
])
def test_serve_batch_tokens_match_jax(arch, prompt_len, gen, use_pallas):
    """moe against the JAX prefill and decode_step, with slots dropped in
    the prefill; hybrid against the JAX serve_batch."""
    jcfg, cfg = tl.configs(arch, use_pallas=use_pallas)
    jp, params = _params(arch)
    prompts = tl.prompts(cfg, B, prompt_len, 0)
    if arch in MOE:
        want = tl.jax_prefill_decode(jcfg, jp, prompts, gen)
    else:
        with tl.jax_serve_with(jp):
            want, _ = jax_serve_batch(jcfg, B, prompt_len, gen, seed=0)
    with moe.recording() as rec:
        got, stats = serve_batch(cfg, B, prompt_len, gen, seed=0,
                                 params=params, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, prompt_len + gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if arch in MOE and prompt_len == 80:
        assert not all(bool(r["kept"].all()) for r in rec)


def _batch(cfg, seed=0, shape=(B, 41)):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's loss, aux and gradients per arch, on weights with
    the attention at its true fan-in (remat changes none of them)."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = tl.configs(arch)
        (loss, aux), grads = jax.value_and_grad(
            jax_get_model(jcfg).loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, tl.weights(arch, fan_in=True)),
            {k: jnp.asarray(v) for k, v in _batch(cfg).items()})
        out[arch] = (float(loss), float(aux["aux"]), dict(tree_items(
            jax.tree.map(np.asarray, grads))))
    return out


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat, jax_grads):
    """``loss_fn`` returns ce + 0.01 x the layers' summed balance loss;
    it and every gradient meet ``jax.value_and_grad(loss_fn)``."""
    want_loss, want_aux, want = jax_grads[arch]
    over = {} if remat is None else {"remat": True, "remat_policy": remat}
    _, cfg = tl.configs(arch, **over)
    params = lm_params_from_numpy(tl.weights(arch, fan_in=True),
                                  "cpu").requires_grad_(True)
    loss, aux = get_model(cfg).loss_fn(
        params, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(aux["aux"].detach()), want_aux,
                               rtol=1e-5)
    assert (want_aux > 0) == (arch in MOE)
    got = {k: t.grad.numpy() for k, t in tree_items(params.tree())}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)
