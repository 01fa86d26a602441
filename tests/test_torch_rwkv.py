"""The port's rwkv family against the JAX package's, on the CPU.

Reduced rwkv6-7b (4 layers, d_model 128, two heads of 64, d_ff 256, vocab
512, rwkv_chunk 16, f32).  Weights come from the JAX package's
``init(PRNGKey(0))`` with the leaves that it leaves at zero drawn live by
``convert.set_rwkv_live_leaves`` (token-shift mixes in (0, 1), bonus u ~
N(0, 0.5^2), base decay w0 in (-6, -1), so that per-step decays reach
0.998 and the state carries across many chunks); one numpy tree feeds both
packages.  Token inputs are made with numpy.  On the CPU the kernel path
(``use_pallas``) runs the op's plain version, a token scan, so both paths
are held to JAX here; the CUDA kernel is held to the plain version on the
card.

Tolerances: single pieces (``wkv_chunked``, time-mix, channel-mix) f32
within 1e-4 relative to the largest entry (the same recurrence summed in
another order, or in other chunks).  Whole-model logits and caches
atol = rtol = 2e-4: the measured gap is under 1e-5 on logits of
magnitude ~1 (the wkv output is rms-normalised over all of D, and the init
is fan-in scaled, so rounding does not grow through the layers), while
dropping the state carried between chunks, or the bonus u, moves them by
more than 1.  WKV states are held to 2e-4 of their
largest entry.  Generated tokens must be equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import lm as jax_lm
from repro.models import rwkv as jax_rwkv
from repro.models.api import get_model as jax_get_model
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, set_rwkv_live_leaves
from repro_torch.kernels.linattn_scan import ops
from repro_torch.launch.serve import serve_batch
from repro_torch.models import lm, rwkv
from repro_torch.models.api import get_model
from repro_torch.sharding.rules import map_defs
from _torch_lm import jax_serve_with as _jax_serve_with

ARCH = "rwkv6-7b"
PIECE_TOL = 1e-4
TOL = 2e-4
B, S = 2, 40        # 40: longer than a kernel tile (32), ragged for both


def _cfgs(**kw):
    return (jax_get_config(ARCH).reduced(**kw), get_config(ARCH).reduced(**kw))


def _live_tree(cfg, seed=0):
    tree = jax.tree.map(np.asarray, jax_get_model(cfg).init(
        jax.random.PRNGKey(seed)))
    set_rwkv_live_leaves(tree, cfg, seed + 1)
    return tree


_PARAMS = {}


def _params():
    """(JAX params, the port's LM) of reduced rwkv6-7b with live leaves."""
    if "p" not in _PARAMS:
        jcfg, _ = _cfgs()
        tree = _live_tree(jcfg)
        _PARAMS["p"] = (jax.tree.map(jnp.asarray, tree),
                        lm_params_from_numpy(tree, "cpu"))
    return _PARAMS["p"]


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


def _rel(port, want):
    want = np.asarray(want, np.float32)
    assert tuple(port.shape) == want.shape
    err = np.abs(port.float().numpy() - want).max()
    return float(err / np.abs(want).max())


def _close(port, jax_out, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


def _close_cache(port: dict, want: dict):
    assert sorted(port) == sorted(want)
    for n in want:
        assert port[n].dtype == getattr(torch, str(np.asarray(want[n]).dtype))
        if n == "wkv":
            assert _rel(port[n], want[n]) <= TOL, n
        else:
            _close(port[n], want[n])


def _layer0(tree, group):
    return jax.tree.map(lambda a: a[0], tree["blocks"][group])


def test_live_leaves_are_drawn_in_their_ranges():
    _, cfg = _cfgs()
    tree = _live_tree(_cfgs()[0])
    tm, cm = tree["blocks"]["time_mix"], tree["blocks"]["channel_mix"]
    for mu in (tm["mu"], cm["mu"]):
        assert mu.dtype == np.float32 and 0 < mu.min() and mu.max() < 1
    assert -6 <= tm["w0"].min() and tm["w0"].max() <= -1
    assert 0.4 < tm["u"].std() < 0.6
    assert (tm["w0"][:, :1] != tm["w0"][:, 1:2]).all()   # per channel
    # the port's LM takes the same draw in place
    params = get_model(cfg).init(torch.Generator().manual_seed(0))
    set_rwkv_live_leaves(params.tree(), cfg, 1)
    np.testing.assert_array_equal(
        params.tree()["blocks"]["time_mix"]["w0"].numpy(), tm["w0"])


@pytest.mark.parametrize("reduced", [True, False])
def test_param_and_cache_defs_match_jax(reduced):
    jcfg, cfg = (jax_get_config(ARCH), get_config(ARCH))
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jm, m = jax_get_model(jcfg), get_model(cfg)
    jdefs = jax.tree.map(lambda d: (d.shape, d.axes, d.init, d.scale),
                         jm.param_defs, is_leaf=lambda x: hasattr(x, "axes"))
    assert map_defs(lambda d: (d.shape, d.axes, d.init, d.scale),
                    m.param_defs) == jdefs
    assert m.n_params() == jm.n_params()
    if not reduced:
        assert m.n_params() == 7_266_111_488
    for seq in (16, 200):
        jc = jax.tree.map(lambda d: (d.shape, d.axes, str(np.dtype(d.dtype))),
                          jm.cache_defs_fn(3, seq),
                          is_leaf=lambda x: hasattr(x, "axes"))
        assert map_defs(lambda d: (d.shape, d.axes,
                                   str(d.dtype).removeprefix("torch.")),
                        m.cache_defs_fn(3, seq)) == jc


def test_state_dict_keys_are_the_jax_paths():
    jp, params = _params()
    flat = {".".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    sd = params.state_dict()
    assert sorted(sd) == sorted(flat)
    assert "blocks.time_mix.wr" in sd and "blocks.channel_mix.mu" in sd
    for k, t in sd.items():
        assert tuple(t.shape) == flat[k].shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(flat[k]))


@pytest.mark.parametrize("Bn,Sn,H,chunk,slow", [
    (2, 50, 2, 16, True),     # 50 = 3 chunks of 16 + 2
    (1, 37, 1, 8, False),
    (2, 20, 2, 128, True),    # one chunk, shorter than the chunk length
])
def test_wkv_chunked_matches_jax(Bn, Sn, H, chunk, slow):
    rng = np.random.default_rng(Sn + chunk)
    r, k, v = (rng.standard_normal((Bn, Sn, H, 64), dtype=np.float32) * 0.5
               for _ in range(3))
    base = rng.uniform(-6, -1, (H, 64)) if slow else np.zeros((H, 64))
    logw = -np.exp(base + rng.standard_normal((Bn, Sn, H, 64)) * 0.3)
    logw = logw.astype(np.float32)
    u = rng.standard_normal((H, 64), dtype=np.float32) * 0.5
    jy, js = jax_rwkv.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                                  chunk)
    ty, ts = rwkv.wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, logw, u)),
                              chunk)
    assert ts.dtype == torch.float32 and ts.shape == (Bn, H, 64, 64)
    assert _rel(ty, jy) < PIECE_TOL
    assert _rel(ts, js) < PIECE_TOL
    # and the op (token scan on the CPU) gives the same, in its layout
    oy, os_ = ops.linattn(*(torch.from_numpy(a).transpose(1, 2)
                            for a in (r, k, v, logw)), torch.from_numpy(u),
                          return_state=True)
    assert _rel(oy.transpose(1, 2), jy) < PIECE_TOL
    assert _rel(os_, js) < PIECE_TOL


def test_token_shift_on_one_token_returns_the_cache():
    x = torch.arange(6.0).reshape(2, 1, 3)
    prev = -torch.ones(2, 3)
    z, last = rwkv._token_shift(x, prev)
    assert torch.equal(z, prev[:, None]) and torch.equal(last, x[:, 0])
    x = torch.arange(12.0).reshape(2, 2, 3)
    z, last = rwkv._token_shift(x, prev)
    assert torch.equal(z[:, 0], prev) and torch.equal(z[:, 1], x[:, 0])
    z, _ = rwkv._token_shift(x, None)
    assert torch.equal(z[:, 0], torch.zeros(2, 3))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_time_mix_matches_jax_without_cache(use_pallas):
    jcfg, cfg = _cfgs(use_pallas=use_pallas)
    jp, params = _params()
    p = _layer0(params.tree(), "time_mix")
    x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model),
                                                 dtype=np.float32)
    want, none = jax_rwkv.apply_time_mix(_layer0(jp, "time_mix"),
                                         jnp.asarray(x), jcfg)
    got, cache = rwkv.apply_time_mix(p, torch.from_numpy(x), cfg)
    assert none is None
    assert _rel(got, want) < PIECE_TOL
    # the cache the sequence leaves: what JAX's decode steps leave
    jc = {"wkv": jnp.zeros((B, 2, 64, 64)), "shift_att": jnp.zeros((B, 128))}
    for t in range(S):
        _, jc = jax_rwkv.apply_time_mix(_layer0(jp, "time_mix"),
                                        jnp.asarray(x[:, t:t + 1]), jcfg,
                                        cache=jc)
    assert _rel(cache["wkv"], jc["wkv"]) < PIECE_TOL
    _close(cache["shift_att"], jc["shift_att"], 0)


def test_time_mix_matches_jax_with_cache():
    jcfg, cfg = _cfgs()
    jp, params = _params()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
    c = {"wkv": rng.standard_normal((B, 2, 64, 64), dtype=np.float32),
         "shift_att": rng.standard_normal((B, cfg.d_model), dtype=np.float32)}
    want, wc = jax_rwkv.apply_time_mix(
        _layer0(jp, "time_mix"), jnp.asarray(x), jcfg,
        cache={n: jnp.asarray(a) for n, a in c.items()})
    got, gc = rwkv.apply_time_mix(
        _layer0(params.tree(), "time_mix"), torch.from_numpy(x), cfg,
        cache={n: torch.from_numpy(a) for n, a in c.items()})
    assert _rel(got, want) < PIECE_TOL
    assert _rel(gc["wkv"], wc["wkv"]) < PIECE_TOL
    _close(gc["shift_att"], wc["shift_att"], 0)


@pytest.mark.parametrize("Sn", [1, S])
@pytest.mark.parametrize("with_cache", [False, True])
def test_channel_mix_matches_jax(Sn, with_cache):
    jcfg, cfg = _cfgs()
    jp, params = _params()
    rng = np.random.default_rng(7 + Sn)
    x = rng.standard_normal((B, Sn, cfg.d_model), dtype=np.float32)
    prev = rng.standard_normal((B, cfg.d_model), dtype=np.float32)
    want, wc = jax_rwkv.apply_channel_mix(
        _layer0(jp, "channel_mix"), jnp.asarray(x), jcfg,
        cache={"shift_ffn": jnp.asarray(prev)} if with_cache else None)
    got, gc = rwkv.apply_channel_mix(
        _layer0(params.tree(), "channel_mix"), torch.from_numpy(x), cfg,
        cache={"shift_ffn": torch.from_numpy(prev)} if with_cache else None)
    assert _rel(got, want) < PIECE_TOL
    if with_cache:
        _close(gc["shift_ffn"], wc["shift_ffn"], 0)
    _close(gc["shift_ffn"], x[:, -1], 0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_match_jax(use_pallas):
    jcfg, cfg = _cfgs(use_pallas=use_pallas)
    jp, params = _params()
    toks = _tokens(cfg)
    want, _, _ = jax_lm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, cache = lm.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert cache is None and got.shape == (B, S, cfg.vocab)
    _close(got, want)


def _jax_decode(jp, jcfg, toks, n):
    """JAX's decode steps over the first ``n`` tokens from a zero cache:
    (logits of each step, the cache they leave)."""
    cache = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype),
                         jax_lm.cache_defs(jcfg, toks.shape[0], n),
                         is_leaf=lambda x: hasattr(x, "axes"))
    step = jax.jit(functools.partial(jax_lm.decode_step, cfg=jcfg))
    out = []
    for pos in range(n):
        logits, cache = step(jp, jnp.asarray(toks[:, pos]), jnp.int32(pos),
                             cache)
        out.append(np.asarray(logits))
    return out, cache


def test_decode_steps_match_jax():
    """Decode steps from an empty cache: every step's logits, and the
    whole cache after the last one."""
    jcfg, cfg = _cfgs()
    jp, params = _params()
    n = 12
    toks = _tokens(cfg, seed=3, shape=(B, n))
    want, wcache = _jax_decode(jp, jcfg, toks, n)
    cache = map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                     lm.cache_defs(cfg, B, n))
    for pos in range(n):
        got, cache = lm.decode_step(params, torch.from_numpy(toks[:, pos]),
                                    pos, cache, cfg)
        _close(got, want[pos])
    _close_cache(cache, wcache)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_cache_matches_jax_decode_cache(use_pallas):
    """The port's prefill leaves the cache that JAX's decode steps leave
    after the prompt (JAX's prefill returns none for rwkv), and the last
    position's logits."""
    jcfg, cfg = _cfgs(use_pallas=use_pallas)
    jp, params = _params()
    toks = _tokens(cfg, seed=4)
    want, wcache = _jax_decode(jp, jcfg, toks, S)
    wlast, none = jax_lm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    assert none is None
    last, cache = lm.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(last, want[-1])
    _close(last, wlast)
    _close_cache(cache, wcache)


def test_deep_kernel_path_meets_plain_path():
    """Why chip_smoke.py can hold the kernel path to the plain
    ``wkv_chunked`` path within 1e-4 at full depth: at depth 32 (width 256,
    live leaves, a 200-token prompt) the two prefill paths, here the token
    scan and chunks of 128, agree on the logits and on every layer's final
    state within 2e-5 of their largest entries."""
    jcfg, cfg = _cfgs(n_layers=32, d_model=256, d_ff=512, rwkv_chunk=128)
    params = lm_params_from_numpy(_live_tree(jcfg), "cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=8, shape=(1, 200)))}
    a, ca = lm.prefill(params, batch, dataclasses.replace(cfg, use_pallas=True))
    b, cb = lm.prefill(params, batch, cfg)
    assert (a - b).abs().max() <= 2e-5 * b.abs().max()
    assert (ca["wkv"] - cb["wkv"]).abs().max() <= 2e-5 * cb["wkv"].abs().max()


@pytest.mark.parametrize("prompt_len,gen,use_pallas", [
    (S, 8, True), (S, 8, False), (7, 5, True)])
def test_serve_batch_tokens_match_jax(prompt_len, gen, use_pallas):
    jcfg, cfg = _cfgs(use_pallas=use_pallas)
    jp, params = _params()
    with _jax_serve_with(jp):
        want, _ = jax_serve_batch(jcfg, B, prompt_len, gen, seed=0)
    got, stats = serve_batch(cfg, B, prompt_len, gen, seed=0, params=params,
                             device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, prompt_len + gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["tokens"] == B * (prompt_len + gen - 1)


def test_init_rwkv_cache_matches_jax():
    jcfg, cfg = _cfgs()
    want = jax_rwkv.init_rwkv_cache(jcfg, 3, jnp.bfloat16)
    got = rwkv.init_rwkv_cache(cfg, 3, torch.bfloat16)
    assert sorted(got) == sorted(want)
    for n, t in got.items():
        assert tuple(t.shape) == want[n].shape and not t.any()
        assert str(t.dtype).removeprefix("torch.") == str(want[n].dtype)
