"""The port's dense-family LM against the JAX package's, on the CPU.

Weights come from the JAX package's ``model.init`` and cross into the port
through ``lm_params_from_numpy``; token inputs are made with numpy.  The
configs are reduced (4 layers, d_model 128, head_dim 32, f32): llama3.2-3b,
the same with grouped KV heads (G = 2), stablelm-3b (layernorm, 25%
rotary), h2o-danube-1.8b (sliding window 64) and mistral-nemo-12b.

Tolerances: single layers atol = rtol = 2e-5 in f32 (the products sum in
another order).  Whole-model logits atol = rtol = 5e-4: the JAX package's
initializer takes the fan-in of ``wq``/``wk`` from their heads axis, so q
and k reach ~20 and attention scores ~100, and f32 rounding there grows
through the residual stream.  Both packages' f32 logits lie within 2.5e-4
of a float64 evaluation (``test_f32_logits_near_float64``), so they may
differ from each other by the sum of the two.  K/V caches hold entries up to ~30 and their gap grows
several-fold from one layer to the next: they are held to a max-norm
relative error of 5e-4 (the largest difference against the largest entry
of the JAX cache).  Generated tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_archs as jax_list_archs
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models.api import get_model as jax_get_model
from repro_torch.configs.base import get_config, list_archs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import serve_batch
from repro_torch.models import layers, lm
from repro_torch.models.api import get_model
from repro_torch.sharding.rules import leaves, map_defs, shapes_from_defs

TOL = 5e-4
ARCHS = ["llama3.2-3b", "llama3.2-3b/gqa", "stablelm-3b", "h2o-danube-1.8b",
         "mistral-nemo-12b"]
B, S = 2, 24


def _cfgs(arch, **kw):
    """(JAX config, port config) of one reduced arch; ``/gqa`` keeps two
    KV heads so that each serves two query heads."""
    name, _, variant = arch.partition("/")
    over = dict(kw, **({"n_kv_heads": 2} if variant == "gqa" else {}))
    return (jax_get_config(name).reduced(**over),
            get_config(name).reduced(**over))


_PARAMS = {}


def _params(arch):
    """JAX params from ``init(PRNGKey(0))`` and the port's copy of them."""
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        jp = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, lm_params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"))
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
    assert port.shape == want.shape
    err = np.abs(port.float().numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_registry_lists_the_ported_configs():
    """Every config of the JAX package's registry, each equal to its
    counterpart there."""
    assert list_archs() == ["h2o-danube-1.8b", "llama3.2-3b",
                            "llama4-scout-17b-a16e", "mistral-nemo-12b",
                            "mixtral-8x7b", "qwen2-vl-72b", "rwkv6-7b",
                            "seamless-m4t-medium", "stablelm-3b",
                            "zamba2-2.7b"]
    assert list_archs() == jax_list_archs()
    for name in list_archs():
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
        assert dataclasses.asdict(get_config(name).reduced()) == \
            dataclasses.asdict(jax_get_config(name).reduced())


def test_every_arch_builds_and_an_unknown_family_raises():
    """``get_model`` builds every arch of the registry, reduced, with the
    JAX package's parameter count; an unknown family raises as the
    reference's ``param_defs`` does."""
    for name in list_archs():
        m = get_model(get_config(name).reduced())
        assert m.n_params() == jax_get_model(
            jax_get_config(name).reduced()).n_params(), name
        assert m.init(torch.Generator().manual_seed(0)) is not None
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              family="audio")
    with pytest.raises(ValueError, match="does not handle family 'audio'"):
        get_model(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_defs_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jm, m = jax_get_model(jcfg), get_model(cfg)
    jdefs = jax.tree.map(lambda d: (d.shape, d.axes, d.init, d.scale),
                         jm.param_defs,
                         is_leaf=lambda x: hasattr(x, "axes"))
    assert map_defs(lambda d: (d.shape, d.axes, d.init, d.scale),
                    m.param_defs) == jdefs
    assert m.n_params() == jm.n_params()
    meta = shapes_from_defs(m.param_defs)
    assert map_defs(lambda d: d.shape, m.param_defs) == jax.tree.map(
        lambda t: tuple(t.shape), meta)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(meta))
    assert jax.tree.map(lambda t: tuple(t.shape), meta) == jax.tree.map(
        lambda t: t.shape, jm.param_shapes())
    for seq in (16, 200):
        jc = jm.cache_defs_fn(3, seq)
        assert map_defs(lambda d: d.shape, m.cache_defs_fn(3, seq)) == \
            {k: jc[k].shape for k in jc}
    # the port's LM keeps the JAX tree's paths, shapes and dtypes
    jp, params = _params(arch)
    flat = {".".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    sd = params.state_dict()
    assert sorted(sd) == sorted(flat)
    for k, t in sd.items():
        assert tuple(t.shape) == flat[k].shape and t.dtype == torch.float32


@pytest.mark.parametrize("arch", ["llama3.2-3b", "stablelm-3b"])
def test_init_uses_fan_in_scaling(arch):
    _, cfg = _cfgs(arch)
    m = get_model(cfg)
    tree = m.init(torch.Generator().manual_seed(0)).tree()
    wi = tree["blocks"]["mlp"]["wi"]
    assert abs(wi.std().item() - cfg.d_model ** -0.5) < 0.05 * cfg.d_model ** -0.5
    assert abs(tree["embed"]["tok"].std().item() - 0.02) < 0.002
    assert (tree["final_norm"]["scale"] == 1).all()
    assert len(leaves(m.param_defs)) == len(list(m.init(
        torch.Generator().manual_seed(1)).parameters()))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "stablelm-3b"])
def test_layers_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, params = _params(arch)
    tree = params.tree()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    l0 = lambda t: jax.tree.map(lambda a: a[0], t)  # noqa: E731
    ln = l0(jp["blocks"]["ln1"])
    ln = {k: v * 1.5 + 0.25 for k, v in ln.items()}   # not all ones/zeros
    _close(layers.apply_norm({k: torch.tensor(np.asarray(v))
                              for k, v in ln.items()}, xt, cfg),
           jax_layers.apply_norm(ln, xj, jcfg), 2e-5)
    _close(layers.rms_norm_simple(xt), jax_layers.rms_norm_simple(xj), 2e-5)
    for act in ("swiglu", "gelu"):
        jc, c = (dataclasses.replace(cf, act=act) for cf in (jcfg, cfg))
        mp = {k: np.asarray(v[0]) for k, v in jp["blocks"]["mlp"].items()}
        _close(layers.apply_mlp({k: torch.tensor(v) for k, v in mp.items()},
                                xt, c),
               jax_layers.apply_mlp({k: jnp.asarray(v) for k, v in mp.items()},
                                    xj, jc), 2e-5)
    hx = rng.standard_normal((B, S, 4, cfg.head_dim), dtype=np.float32)
    pos = np.arange(S, dtype=np.int32)[None] + 1000
    _close(layers.apply_rope(torch.from_numpy(hx), torch.from_numpy(pos), cfg),
           jax_layers.apply_rope(jnp.asarray(hx), jnp.asarray(pos), jcfg), 2e-5)
    toks = _tokens(cfg)
    _close(layers.embed_tokens(tree["embed"], torch.from_numpy(toks), cfg),
           jax_layers.embed_tokens(jp["embed"], jnp.asarray(toks), jcfg), 0)
    for tie in (True, False):
        jc, c = (dataclasses.replace(cf, tie_embeddings=tie)
                 for cf in (jcfg, cfg))
        ep = {"tok": np.asarray(jp["embed"]["tok"]),
              "unembed": np.asarray(jp["embed"]["tok"]).T * 2}
        _close(layers.logits_from_hidden(
                   {k: torch.tensor(v) for k, v in ep.items()}, xt, c),
               jax_layers.logits_from_hidden(
                   {k: jnp.asarray(v) for k, v in ep.items()}, xj, jc), 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, params = _params(arch)
    toks = _tokens(cfg)
    want, _, _ = jax_lm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, cache = lm.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert cache is None and got.shape == (B, S, cfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_logits_near_float64(arch):
    """The basis of TOL: the JAX package's f32 logits and the port's each
    lie within TOL / 2 of the port's float64 evaluation of the model (its
    norms stay f32 in every dtype, as in the JAX package)."""
    jcfg, cfg = _cfgs(arch)
    jp, params = _params(arch)
    toks = _tokens(cfg)
    want, _, _ = jax_lm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = lm.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    p64 = lm.LM(jax.tree.map(lambda t: t.double(), params.tree()))
    ref, _ = lm.forward(p64, {"tokens": torch.from_numpy(toks)},
                        dataclasses.replace(cfg, dtype="float64"))
    ref = ref.numpy()
    assert np.abs(np.asarray(want) - ref).max() <= TOL / 2
    assert np.abs(got.numpy() - ref).max() <= TOL / 2


def test_deep_random_model_is_chaotic_unless_fan_in_scaled():
    """Why chip_smoke.py's full-width f32 check rescales the attention
    projections: at depth 28 with the JAX package's init, a change of the
    blockwise path's tile size alone moves the logits by more than 0.1
    (f32 rounding grows through the layers); with wq/wk/wv at std
    d_model^-0.5 and wo at (H hd)^-0.5, as ``fan_in_attention`` there
    draws them, the kernel path and both tilings agree within 1e-4."""
    cfg = get_config("llama3.2-3b").reduced(
        n_layers=28, d_model=256, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=512, block_q=512, block_k=512)
    params = get_model(cfg).init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(_tokens(cfg, shape=(1, 128)))}

    def gaps():
        a, _ = lm.prefill(params, batch, cfg)
        b, _ = lm.prefill(params, batch, dataclasses.replace(
            cfg, block_q=32, block_k=32))
        c, _ = lm.prefill(params, batch, dataclasses.replace(
            cfg, use_pallas=True))
        return (a - b).abs().max().item(), (a - c).abs().max().item()

    assert gaps()[0] > 0.1
    attn = params.tree()["blocks"]["attn"]
    for n in ("wq", "wk", "wv"):          # [L, D, heads, hd]
        attn[n].mul_((attn[n].shape[2] / cfg.d_model) ** 0.5)
    attn["wo"].mul_(attn["wo"].shape[1] ** -0.5)
    assert max(gaps()) < 1e-4


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, use_pallas):
    jcfg, cfg = _cfgs(arch, use_pallas=use_pallas)
    jp, params = _params(arch)
    toks = _tokens(cfg, seed=2)
    want, wcache = jax_lm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, cache = lm.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(got, want)
    for n in ("k", "v"):
        _close_cache(cache[n], wcache[n])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """Two decode steps after a prefill, on the JAX cache padded to the
    decode length: logits and the whole updated cache."""
    jcfg, cfg = _cfgs(arch)
    jp, params = _params(arch)
    toks = _tokens(cfg, seed=3)
    _, jcache = jax_lm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    C = min(S + 2, cfg.window or S + 2)
    pad = lambda a: np.pad(np.asarray(a), [(0, 0), (0, 0), (0, C - S),  # noqa: E731
                                           (0, 0), (0, 0)])
    jc = {n: jnp.asarray(pad(jcache[n])) for n in ("k", "v")}
    tc = {n: torch.from_numpy(pad(jcache[n])) for n in ("k", "v")}
    for step, tok in enumerate(_tokens(cfg, seed=4, shape=(2, B))):
        pos = S + step
        want, jc = jax_lm.decode_step(jp, jnp.asarray(tok), jnp.int32(pos),
                                      jc, jcfg)
        got, tc = lm.decode_step(params, torch.from_numpy(tok), pos, tc, cfg)
        _close(got, want)
        for n in ("k", "v"):
            _close_cache(tc[n], jc[n])


@pytest.mark.parametrize("arch", ["llama3.2-3b/gqa", "h2o-danube-1.8b"])
def test_decode_matches_forward(arch):
    """Decoding a sequence token by token from an empty cache gives the
    full forward's logits at every position (the window config's ring
    wraps: 80 positions through a 64-slot cache)."""
    _, cfg = _cfgs(arch)
    _, params = _params(arch)
    n = 80 if cfg.window else S
    toks = torch.from_numpy(_tokens(cfg, seed=6, shape=(B, n)))
    full, _ = lm.forward(params, {"tokens": toks}, cfg)
    cache = map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                     lm.cache_defs(cfg, B, n))
    assert cache["k"].shape[2] == (64 if cfg.window else n)
    for pos in range(n):
        got, cache = lm.decode_step(params, toks[:, pos], pos, cache, cfg)
        np.testing.assert_allclose(got.numpy(), full[:, pos].numpy(),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,prompt_len,gen,use_pallas", [
    ("llama3.2-3b", 24, 8, True),
    ("llama3.2-3b", 24, 8, False),
    ("llama3.2-3b/gqa", 20, 6, True),
    ("stablelm-3b", 24, 8, True),
    ("h2o-danube-1.8b", 72, 8, True),   # prompt longer than the 64 window
    ("mistral-nemo-12b", 16, 6, True),
])
def test_serve_batch_tokens_match_jax(arch, prompt_len, gen, use_pallas):
    jcfg, cfg = _cfgs(arch, use_pallas=use_pallas)
    jp, params = _params(arch)
    want, _ = jax_serve_batch(jcfg, B, prompt_len, gen, seed=0)
    got, stats = serve_batch(cfg, B, prompt_len, gen, seed=0, params=params,
                             device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, prompt_len + gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["tokens"] == B * (prompt_len + gen - 1)


def test_serve_batch_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("llama3.2-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch(cfg, 1, 4, 2)
