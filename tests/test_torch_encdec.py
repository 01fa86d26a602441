"""The port's encoder-decoder (seamless-m4t-medium) against the JAX
package's, on the CPU.

Reduced seamless-m4t-medium: 2 encoder and 4 decoder layers, d_model 128,
4 heads of 32, LayerNorm, gelu, f32.  Weights are the seeded numpy trees
of ``_torch_lm.weights`` with every LayerNorm's scale and bias drawn live
and the attention at its true fan-in: with the reference's initializer
(fan-in from the heads axis) a random model is chaotic, and the two
packages' logits part by ~7e-4 of a largest logit ~1, where with it
scaled they part by ~1e-6.  Tolerances as tests/test_torch_lm.py states
them: logits atol = rtol = 5e-4, K/V caches a max-norm relative error of
5e-4, generated tokens equal; the loss within rtol 1e-5 and every gradient
within atol 1e-5 + rtol 1e-4 of ``jax.value_and_grad(loss_fn)``.

The JAX package has no encdec prefill that returns a cache, and its
``serve_batch`` decodes against a cross cache of zeros (it never draws a
source).  So the port's ``prefill`` cache is held to the JAX ``encode``
times each layer's ``cross_attn.wk``/``wv`` and to the self-attention K/V
the JAX decode steps write, and its tokens to
``_torch_lm.jax_encdec_decode`` with that cross cache.
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

import _torch_lm as tl
import repro.launch.serve as jax_serve
from repro.launch import train as jax_train_cli
from repro.models import encdec as jax_encdec
from repro.models.api import get_model as jax_get_model
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import request_inputs, serve_batch
from repro_torch.models import attention, encdec
from repro_torch.models.api import get_model
from repro_torch.runtime.trainer import Trainer
from repro_torch.sharding.rules import map_defs, shapes_from_defs
from repro_torch.tree import tree_items

ARCH = "seamless-m4t-medium"
TOL = 5e-4
B, S_SRC, S_TGT = 2, 19, 24
REMAT = [None, "nothing"]

_PARAMS = {}


def _params():
    """(JAX params, the port's copy of them), fan-in weights."""
    if not _PARAMS:
        tree = tl.weights(ARCH, fan_in=True)
        _PARAMS["p"] = (jax.tree.map(jnp.asarray, tree),
                        lm_params_from_numpy(tree, "cpu"))
    return _PARAMS["p"]


def _batch(cfg, seed=1, s_src=S_SRC, s_tgt=S_TGT):
    rng = np.random.default_rng(seed)
    return {"src_embeds": rng.standard_normal((B, s_src, cfg.d_model),
                                              dtype=np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, s_tgt)).astype(np.int32)}


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


def _jax_self_cache(jcfg, jp, batch, total):
    """The self-attention K/V the JAX decode steps write over the batch's
    target prompt, with the cross cache from the JAX ``encode``; sized for
    ``total`` positions."""
    cross = tl.jax_cross_cache(jcfg, jp, batch["src_embeds"])
    defs = jax_encdec.cache_defs(jcfg, B, total, batch["src_embeds"].shape[1])
    cache = {"self": {n: jnp.zeros(d.shape, d.dtype)
                      for n, d in defs["self"].items()}, "cross": cross}
    step = jax.jit(lambda p, t, pos, c: jax_encdec.decode_step(
        p, t, pos, c, jcfg))
    for p in range(batch["tokens"].shape[1]):
        _, cache = step(jp, jnp.asarray(batch["tokens"][:, p]), jnp.int32(p),
                        cache)
    return jax.tree.map(np.asarray, cache)


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
    for seq in (1, 16, 201):
        assert map_defs(lambda d: (d.shape, d.axes, d.dtype),
                        m.cache_defs_fn(3, seq)) == jax.tree.map(
            lambda d: (d.shape, d.axes, getattr(torch, str(d.dtype))),
            jm.cache_defs_fn(3, seq), is_leaf=is_def)
    # the port's LM holds the nested tree with the JAX paths
    jp, params = _params()
    flat = {".".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    sd = params.state_dict()
    assert sorted(sd) == sorted(flat)
    assert "decoder.cross_attn.wk" in sd and "frontend_proj" in sd
    for k, t in sd.items():
        assert tuple(t.shape) == flat[k].shape and t.dtype == torch.float32
    assert params["frontend_proj"] is params.tree()["frontend_proj"]


def test_full_width_parameter_count():
    """seamless-m4t-medium is served uncut on the card: ~6.2e8 parameters."""
    m = get_model(get_config(ARCH))
    assert m.n_params() == jax_get_model(
        tl.jax_get_config(ARCH)).n_params() == 615_852_032


def test_live_leaves_cover_every_layernorm():
    """``live_seed`` draws every LayerNorm's scale and bias (ones and zeros
    from ``init``), so a norm in the wrong place shows."""
    _, cfg = tl.configs(ARCH)
    plain = dict(tree_items(numpy_lm_params(cfg, 0)))
    live = dict(tree_items(numpy_lm_params(cfg, 0, live_seed=1)))
    norms = [k for k in plain if k.endswith(("/scale", "/bias"))]
    assert len(norms) == 2 * 7
    for k in plain:
        assert (k in norms) != np.array_equal(plain[k], live[k]), k


def test_encode_matches_jax():
    jcfg, cfg = tl.configs(ARCH)
    jp, params = _params()
    batch = _batch(cfg)
    want = jax_encdec.encode(jp, jnp.asarray(batch["src_embeds"]), jcfg)
    for use_pallas in (False, True):
        got = encdec.encode(params, torch.from_numpy(batch["src_embeds"]),
                            dataclasses.replace(cfg, use_pallas=use_pallas))
        _close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_match_jax(use_pallas):
    jcfg, cfg = tl.configs(ARCH, use_pallas=use_pallas)
    jp, params = _params()
    batch = _batch(cfg)
    want = jax_encdec.forward(jp, _jax(batch), jcfg)
    got = encdec.forward(params, _torch(batch), cfg)
    assert got.shape == (B, S_TGT, cfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_jax(use_pallas):
    """Last-position logits against the JAX ``forward[:, -1]``; the cross
    cache against the JAX ``encode`` times each layer's
    ``cross_attn.wk``/``wv``; the self cache against the K/V the JAX
    decode steps write over the prompt."""
    jcfg, cfg = tl.configs(ARCH, use_pallas=use_pallas)
    jp, params = _params()
    batch = _batch(cfg, seed=2)
    last, cache = get_model(cfg).prefill(params, _torch(batch))
    _close(last, jax_encdec.forward(jp, _jax(batch), jcfg)[:, -1])
    cross = tl.jax_cross_cache(jcfg, jp, batch["src_embeds"])
    steps = _jax_self_cache(jcfg, jp, batch, S_TGT)
    for n in ("k", "v"):
        assert tuple(cache["cross"][n].shape) == (
            cfg.n_layers, B, S_SRC, cfg.kv_heads_c, cfg.head_dim)
        _close_cache(cache["cross"][n], cross[n])
        _close_cache(cache["self"][n], steps["self"][n])


def test_decode_step_matches_jax():
    """Two decode steps from the same cache: logits and the whole updated
    cache."""
    jcfg, cfg = tl.configs(ARCH)
    jp, params = _params()
    batch = _batch(cfg, seed=3)
    start = _jax_self_cache(jcfg, jp, batch, S_TGT + 2)
    jc = jax.tree.map(jnp.asarray, start)
    tc = tl.torch_tree(start)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, B)).astype(
        np.int32)
    for step, tok in enumerate(toks):
        pos = S_TGT + step
        want, jc = jax_encdec.decode_step(jp, jnp.asarray(tok), jnp.int32(pos),
                                          jc, jcfg)
        got, tc = encdec.decode_step(params, torch.from_numpy(tok), pos, tc,
                                     cfg)
        _close(got, want)
        want_cache = dict(tree_items(jc))
        for k, t in tree_items(tc):
            _close_cache(t, want_cache[k])


def test_decode_matches_forward():
    """Decoding the target token by token from an empty self cache, with
    the prefill's cross cache, gives the full forward's logits at every
    position."""
    _, cfg = tl.configs(ARCH)
    _, params = _params()
    batch = _torch(_batch(cfg, seed=6))
    full = encdec.forward(params, batch, cfg)
    _, pre = encdec.prefill(params, batch, cfg)
    cache = {"self": map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                              encdec.cache_defs(cfg, B, S_TGT, S_SRC)["self"]),
             "cross": pre["cross"]}
    for pos in range(S_TGT):
        got, cache = encdec.decode_step(params, batch["tokens"][:, pos], pos,
                                        cache, cfg)
        np.testing.assert_allclose(got.numpy(), full[:, pos].numpy(),
                                   atol=TOL, rtol=TOL)


def test_kernel_path_takes_three_attentions_a_layer(monkeypatch):
    """With ``use_pallas`` every attention goes through the flash op: per
    layer the encoder's (bidirectional, S_src x S_src), the decoder's self-
    (causal) and cross-attention (non-causal, S_tgt x S_src); without it
    none does."""
    _, cfg = tl.configs(ARCH)
    _, params = _params()
    calls = []
    real = attention.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", counting)
    batch = _torch(_batch(cfg))
    encdec.prefill(params, batch, cfg)
    assert calls == []
    encdec.prefill(params, batch, dataclasses.replace(cfg, use_pallas=True))
    assert calls == ([(S_SRC, S_SRC, False)] * cfg.enc_layers
                     + [(S_TGT, S_TGT, True), (S_TGT, S_SRC, False)]
                     * cfg.n_layers)


@pytest.fixture(scope="module")
def jax_grads():
    jcfg, cfg = tl.configs(ARCH)
    batch = _batch(cfg, seed=5, s_tgt=41)
    batch = {"src_embeds": batch["src_embeds"],
             "tokens": batch["tokens"][:, :-1],
             "labels": batch["tokens"][:, 1:]}
    (loss, aux), grads = jax.value_and_grad(
        jax_get_model(jcfg).loss_fn, has_aux=True)(_params()[0], _jax(batch))
    return batch, float(loss), dict(tree_items(
        jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("remat", REMAT)
def test_loss_and_grads_match_jax(remat, jax_grads):
    batch, want_loss, want = jax_grads
    over = {} if remat is None else {"remat": True, "remat_policy": remat}
    _, cfg = tl.configs(ARCH, **over)
    params = lm_params_from_numpy(tl.weights(ARCH, fan_in=True),
                                  "cpu").requires_grad_(True)
    loss, aux = get_model(cfg).loss_fn(params, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert float(aux["aux"]) == 0.0
    assert float(aux["ce"].detach()) == float(loss.detach())
    got = {k: t.grad.numpy() for k, t in tree_items(params.tree())}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_loss_fn_takes_the_blockwise_path_under_use_pallas(monkeypatch):
    """The kernel has no backward pass: ``loss_fn`` never reaches it,
    whatever ``use_pallas`` says, and its loss is the blockwise one."""
    _, cfg = tl.configs(ARCH)
    monkeypatch.setattr(attention, "flash_attention", None)
    params = lm_params_from_numpy(tl.weights(ARCH, fan_in=True), "cpu")
    batch = _batch(cfg, seed=5)
    batch["labels"] = batch["tokens"]
    a, _ = encdec.loss_fn(params, _torch(batch), cfg)
    b, _ = encdec.loss_fn(params, _torch(batch),
                          dataclasses.replace(cfg, use_pallas=True))
    assert float(a) == float(b)


def test_request_inputs_split_as_the_input_specs():
    """A request of S positions: S // 2 source frames and S - S // 2
    target tokens, drawn after the tokens from one generator."""
    _, cfg = tl.configs(ARCH)
    got = request_inputs(cfg, B, 75, 3)
    want = tl.jax_inputs(cfg, B, 75, 3)
    assert got["tokens"].shape == (B, 38) and got["src_embeds"].shape == (
        B, 37, cfg.d_model)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("S,gen,use_pallas", [(75, 8, True), (40, 6, False),
                                              (3, 4, True)])
def test_serve_batch_tokens_match_jax(S, gen, use_pallas):
    """The port's request path against the JAX decode steps over the
    prompt with the cross cache made from the JAX ``encode``; S odd makes
    the cross-attention ragged (37 frames against 38 tokens)."""
    jcfg, cfg = tl.configs(ARCH, use_pallas=use_pallas)
    jp, params = _params()
    inputs = tl.jax_inputs(cfg, B, S, 0)
    cross = tl.jax_cross_cache(jcfg, jp, inputs["src_embeds"])
    want, last = tl.jax_encdec_decode(jcfg, jp, inputs["tokens"], gen, cross)
    got, stats = serve_batch(cfg, B, S, gen, seed=0, params=params,
                             device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, S - S // 2 + gen)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["tokens"] == B * (S + gen - 1)
    logits, _ = get_model(cfg).prefill(params, _torch(inputs))
    _close(logits, last)


def test_jax_serve_batch_ignores_the_source():
    """The reference fault the port does not copy: the JAX ``serve_batch``
    decodes against a cross cache of zeros, so its tokens are those of a
    zero cross cache whatever the source, where a source's own cross cache
    gives others."""
    jcfg, cfg = tl.configs(ARCH)
    jp, _ = _params()
    S, gen = 40, 8
    with tl.jax_serve_with(jp):
        served, _ = jax_serve.serve_batch(jcfg, B, S, gen, seed=0)
    served = np.asarray(served)
    prompt = tl.prompts(cfg, B, S, 0)
    np.testing.assert_array_equal(served[:, :S], prompt)
    L, KV, hd = cfg.n_layers, cfg.kv_heads_c, cfg.head_dim
    for src_len in (1, (S + gen) // 2):
        zeros = {n: np.zeros((L, B, src_len, KV, hd), np.float32)
                 for n in ("k", "v")}
        want, _ = tl.jax_encdec_decode(jcfg, jp, prompt, gen, zeros)
        np.testing.assert_array_equal(served, want)
    sources = [np.random.default_rng(s).standard_normal(
        (B, S // 2, cfg.d_model), dtype=np.float32) for s in (1, 2)]
    real = [tl.jax_encdec_decode(jcfg, jp, prompt, gen, tl.jax_cross_cache(
        jcfg, jp, src))[0] for src in sources]
    assert not np.array_equal(real[0], served)
    assert not np.array_equal(real[0], real[1])


def test_prefill_cache_keeps_the_cross_cache():
    """``_prefill_cache`` lays the prompt's self K/V into a cache of the
    decode length and keeps the prefill's cross K/V, whose length is the
    source's (a longer one would attend to zero keys)."""
    _, cfg = tl.configs(ARCH)
    _, params = _params()
    model = get_model(cfg)
    _, pre = model.prefill(params, _torch(_batch(cfg)))
    cache = serve_mod._prefill_cache(model, pre, B, S_TGT + 5, "cpu")
    assert cache["cross"] is pre["cross"]
    for n in ("k", "v"):
        assert cache["self"][n].shape[2] == S_TGT + 5
        assert torch.equal(cache["self"][n][:, :, :S_TGT], pre["self"][n])
        assert not cache["self"][n][:, :, S_TGT:].any()


def _fixed_init(trainer_cls, tree_of, to_params, seen):
    """A ``Trainer`` subclass whose ``_init_state`` starts from the numpy
    weights ``tree_of(cfg)`` of the config it was built with (recorded in
    ``seen``)."""
    class Fixed(trainer_cls):
        def __init__(self, cfg, *args, **kw):
            super().__init__(cfg, *args, **kw)
            seen.append(cfg)
            real = self._init_state

            def init_state():
                p, opt, comp = real()
                return to_params(tree_of(cfg), p), opt, comp
            self._init_state = init_state
    return Fixed


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-72b"])
def test_launch_train_swaps_the_family_as_the_reference_cli(arch, tmp_path,
                                                            monkeypatch):
    """``launch/train.py --arch <vlm or encdec>`` trains the text stack as a
    dense LM, as the reference CLI does: the same swapped config, and, from
    the same weights, the same first losses."""
    trees, seen_j, seen_t = {}, [], []

    def tree_of(cfg):
        key = cfg.name
        if key not in trees:
            trees[key] = numpy_lm_params(get_config(cfg.name).reduced(
                family="dense", frontend=None, enc_layers=0), 0, fan_in=True)
        return trees[key]

    def to_jax(tree, p):
        return jax.tree.map(jnp.asarray, tree)

    def to_torch(tree, p):
        return lm_params_from_numpy(tree, "cpu")

    monkeypatch.setattr(jax_train_cli, "Trainer",
                        _fixed_init(JaxTrainer, tree_of, to_jax, seen_j))
    monkeypatch.setattr(train_cli, "Trainer",
                        _fixed_init(Trainer, tree_of, to_torch, seen_t))
    argv = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16"]
    want = jax_train_cli.main(argv + ["--out", str(tmp_path / "j.json")])
    got = train_cli.main(argv + ["--device", "cpu", "--out",
                                 str(tmp_path / "t.json")])
    assert len(seen_j) == len(seen_t) == 1
    assert dataclasses.asdict(seen_t[0]) == dataclasses.asdict(seen_j[0])
    assert seen_t[0].family == "dense" and seen_t[0].enc_layers == 0
    assert [h["step"] for h in got["history"]] == [0, 1]
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=1e-5)


def test_launch_train_cli_runs_seamless():
    """The command line itself: it trained nothing before (the family
    raised)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
           "--seq", "16"]
    done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr
    assert "final loss" in done.stdout

