"""The port's Mamba2 block against the JAX package's, on the CPU.

Reduced zamba2-2.7b (d_model 128, d_inner 256, 8 heads of 32, state 16,
chunks of 16), f32, the seeded numpy weights of Mamba2 layer (0, 0) with
the leaves that ``init`` leaves at zero or one drawn live
(``convert.set_ssm_live_leaves``), inputs from numpy.  Tolerances: atol =
rtol = 2e-5 (sums in another order); the chunked scan against the
one-step recurrence at the JAX test's 2e-4 / 2e-3
(tests/test_models.py::test_ssd_chunked_matches_step_recurrence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_lm as tl
from repro.models import ssm as jax_ssm
from repro_torch.models import ssm

ARCH = "zamba2-2.7b"
B = 2


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _layer(j=0):
    """(JAX config, port config, Mamba2 layer (0, j)'s leaves as numpy)."""
    jcfg, cfg = tl.configs(ARCH)
    return jcfg, cfg, jax.tree.map(lambda a: np.asarray(a[0, j]),
                                   tl.weights(ARCH)["mamba"])


def _ssd_inputs(S, H=3, P=8, N=4, seed=0):
    """x, dt (> 0, through the softplus, most steps slow to decay), A
    (< 0), Bm, Cm as numpy f32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    x = f(B, S, H, P)
    dt = np.log1p(np.exp(f(B, S, H) - 3.0)).astype(np.float32)
    A = -np.exp(f(H) * 0.5).astype(np.float32)
    return x, dt, A, f(B, S, N) * 0.5, f(B, S, N) * 0.5


def test_live_leaves_are_drawn():
    _, cfg, p = _layer()
    for n in ("A_log", "dt_bias", "conv_b"):
        assert np.abs(p[n]).min() > 0, n
    for n in ("D_skip", "norm_scale"):
        assert (p[n] != 1).all(), n
    assert (p["dt_bias"] < 0).all()     # inverse softplus of dt < 0.1


@pytest.mark.parametrize("S", [1, 2, 3, 5, 40])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(S, with_state):
    """Fewer inputs than the conv's width (S < 3) take zeros, or the
    given state, in front; the new state is the last 3 inputs before the
    conv."""
    _, cfg, p = _layer()
    rng = np.random.default_rng(S)
    Cd = cfg.d_inner + 2 * cfg.ssm_state
    x = rng.standard_normal((B, S, Cd), dtype=np.float32)
    st = (rng.standard_normal((B, ssm.CONV_K - 1, Cd), dtype=np.float32)
          if with_state else None)
    want, wst = jax_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(p["conv_w"]), jnp.asarray(p["conv_b"]),
        None if st is None else jnp.asarray(st))
    got, gst = ssm._causal_conv(
        torch.from_numpy(x), torch.from_numpy(p["conv_w"]),
        torch.from_numpy(p["conv_b"]),
        None if st is None else torch.from_numpy(st))
    _close(got, want)
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


@pytest.mark.parametrize("S,chunk", [(40, 16), (37, 8), (16, 16), (5, 16),
                                     (1, 16)])
def test_ssd_chunked_matches_jax(S, chunk):
    """y and the final state, with a ragged last chunk (40 = 2 x 16 + 8,
    37 = 4 x 8 + 5), one whole chunk, and a sequence shorter than one."""
    x, dt, A, Bm, Cm = _ssd_inputs(S)
    want, wst = jax_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                     chunk)
    got, gst = ssm._ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                                chunk)
    assert got.shape == x.shape and gst.shape == (B, 3, 8, 4)
    _close(got, want)
    _close(gst, wst)


def test_ssd_chunked_matches_step_recurrence():
    """The chunk-parallel form against the one-step recurrence, with the
    state carried over two chunk edges and a ragged tail."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _ssd_inputs(40, seed=1))
    y, fin = ssm._ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    st = torch.zeros(B, 3, 8, 4)
    ys = []
    for t in range(40):
        a = torch.exp(dt[:, t] * A)
        st = a[:, :, None, None] * st + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], st))
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(fin.numpy(), st.numpy(), atol=2e-4, rtol=2e-3)


def test_padding_follows_the_softplus():
    """A ragged tail's padded steps have dt = 0 (decay 1, no input), so the
    final state equals that of the unpadded recurrence; padding dt before
    the softplus would add softplus(0) = 0.69 a padded step."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _ssd_inputs(20, seed=2))
    _, ragged = ssm._ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    _, whole = ssm._ssd_chunked(x, dt, A, Bm, Cm, chunk=20)
    np.testing.assert_allclose(ragged.numpy(), whole.numpy(), atol=1e-5,
                               rtol=1e-5)
    bad = torch.cat([dt, F.softplus(torch.zeros(B, 12, 3))], dim=1)
    pad = lambda a: torch.cat([a, a.new_zeros((B, 12) + a.shape[2:])], 1)  # noqa: E731
    _, wrong = ssm._ssd_chunked(pad(x), bad, A, pad(Bm), pad(Cm), chunk=16)
    assert (wrong - whole).abs().max() > 1e-2


@pytest.mark.parametrize("j", [0, 1])
def test_apply_ssm_chunked_matches_jax(j):
    """The whole-sequence block (S = 40: two chunks and a ragged one) on
    Mamba2 layers (0, 0) and (0, 1); its cache is the state the JAX
    package's decode steps leave after the same 40 tokens."""
    jcfg, cfg, p = _layer(j)
    x = np.random.default_rng(10 + j).standard_normal(
        (B, 40, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    want, wcache = jax_ssm.apply_ssm(jp, jnp.asarray(x), jcfg)
    assert wcache is None
    got, cache = ssm.apply_ssm(tl.torch_tree(p), torch.from_numpy(x), cfg)
    _close(got, want)
    jc = jax_ssm.init_ssm_cache(jcfg, B, jnp.float32)
    for t in range(40):
        _, jc = jax_ssm.apply_ssm(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                  cache=jc)
    _close(cache["ssm_state"], jc["ssm_state"], 2e-4)
    _close(cache["conv"], jc["conv"])


def test_apply_ssm_step_matches_jax():
    """Three single steps from a random cache: the output and the new
    state and conv tail."""
    jcfg, cfg, p = _layer()
    rng = np.random.default_rng(11)
    shapes = {k: v.shape for k, v in
              jax_ssm.init_ssm_cache(jcfg, B, jnp.float32).items()}
    c0 = {k: rng.standard_normal(s, dtype=np.float32) * 0.5
          for k, s in shapes.items()}
    jc, tc = jax.tree.map(jnp.asarray, c0), tl.torch_tree(c0)
    jp, tp = jax.tree.map(jnp.asarray, p), tl.torch_tree(p)
    for t in range(3):
        x = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        want, jc = jax_ssm.apply_ssm(jp, jnp.asarray(x), jcfg, cache=jc)
        got, tc = ssm.apply_ssm(tp, torch.from_numpy(x), cfg, cache=tc)
        _close(got, want)
        for k in shapes:
            _close(tc[k], jc[k])


def test_init_ssm_cache_matches_jax():
    jcfg, cfg, _ = _layer()
    want = jax_ssm.init_ssm_cache(jcfg, 3, jnp.float32)
    got = ssm.init_ssm_cache(cfg, 3, torch.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert all(not v.any() for v in got.values())


def test_ssm_grads_match_jax():
    """d(sum(out * c)) by x and every leaf of the block, S = 40, within
    rtol 1e-4 and an atol of 1e-5 of the leaf's largest entry: with c ~
    N(0, 1) a leaf's gradient sums 80 positions' terms and reaches ~100,
    where f32 sums in another order part by ~5e-5."""
    jcfg, cfg, p = _layer()
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, 40, cfg.d_model), dtype=np.float32)
    c = rng.standard_normal(x.shape, dtype=np.float32)
    want_p, want_x = jax.grad(
        lambda p, x: jnp.sum(jax_ssm.apply_ssm(p, x, jcfg)[0]
                             * jnp.asarray(c)), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tl.torch_tree(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = ssm.apply_ssm(tp, tx, cfg)
    torch.sum(out * torch.from_numpy(c)).backward()
    for k, got, want in [("x", tx.grad, want_x)] + [
            (k, tp[k].grad, want_p[k]) for k in p]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, err_msg=k,
                                   atol=1e-5 * np.abs(want).max())
