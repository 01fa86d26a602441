"""The port's AdamW and int8 gradient compression against the JAX
package's, on the CPU.

The same numpy gradients go into both packages' ``adamw_update`` for six
steps that cross the warmup's end and the clip threshold: parameters and
both moments within 2e-7 absolute + 1e-6 relative (f32 rounding of the
same formulas; the order of the products inside a fused XLA expression may
differ), the grad norm and lr within 1e-6 relative.  ``compress_gradients``
is held bit for bit: the int8 payload comes from the same f32 operations
(``torch.round`` rounds half to even, as ``jnp.round`` does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_comp
from repro_torch.convert import (
    compression_state_from_numpy, opt_state_from_numpy, state_to_numpy,
)
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, compress_gradients,
    compression_init, cosine_schedule, global_norm, payload_bytes,
)
from repro_torch.optim.compression import _quantize_int8

SHAPES = {"a": (8, 16), "nested": {"b": (5,), "c": (3, 4, 2)}, "z": ()}


def _tree(rng, scale=1.0):
    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(s) for k, s in shape.items()}
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return draw(SHAPES)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(port, ref, atol=2e-7, rtol=1e-6):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(
            state_to_numpy(port))[0], jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol,
                                   err_msg=str(path))


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_update_matches_jax_across_warmup_and_clip(wd):
    """Six steps: warmup ends at step 3; the gradients' norm is ~10 on
    odd steps (clipped to 1) and ~0.1 on even ones (not clipped)."""
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, weight_decay=wd, warmup_steps=3, total_steps=10)
    p0 = _tree(rng)
    jp, js = jax.tree.map(jnp.asarray, p0), jax_adamw.adamw_init(
        jax.tree.map(jnp.asarray, p0))
    tp = _torch(p0)
    ts = adamw_init(tp)
    clipped = []
    for step in range(6):
        g = _tree(rng, scale=0.7 if step % 2 else 0.007)
        jp, js, jm = jax_adamw.adamw_update(
            jax.tree.map(jnp.asarray, g), js, jp,
            jax_adamw.AdamWConfig(**cfg))
        tp, ts, tm = adamw_update(_torch(g), ts, tp, AdamWConfig(**cfg))
        _close(tp, jp)
        _close(ts.m, js.m)
        _close(ts.v, js.v)
        assert int(ts.step) == int(js.step) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        clipped.append(float(tm["grad_norm"]) > 1.0)
    assert clipped == [False, True] * 3


def test_cosine_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = [float(cosine_schedule(AdamWConfig(**cfg),
                                 torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 121)]
    want = [float(jax_adamw.cosine_schedule(jax_adamw.AdamWConfig(**cfg),
                                            jnp.int32(s)))
            for s in range(0, 121)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0 and abs(got[10] - 3e-4) < 1e-9
    assert abs(got[120] - 3e-5) < 1e-10


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(1))
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(jax_adamw.global_norm(tree)), rtol=1e-6)


def test_opt_state_crosses_from_numpy():
    """Moments and step carried from the reference's state go on updating
    as the reference's do."""
    rng = np.random.default_rng(2)
    p = _tree(rng)
    jcfg, cfg = jax_adamw.AdamWConfig(lr=0.1), AdamWConfig(lr=0.1)
    jp, js, _ = jax_adamw.adamw_update(
        jax.tree.map(jnp.asarray, _tree(rng)),
        jax_adamw.adamw_init(jax.tree.map(jnp.asarray, p)),
        jax.tree.map(jnp.asarray, p), jcfg)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js.m),
                              jax.tree.map(np.asarray, js.v),
                              js.step, "cpu")
    tp = _torch(jax.tree.map(np.asarray, jp))
    g = _tree(rng)
    jp, js, _ = jax_adamw.adamw_update(jax.tree.map(jnp.asarray, g), js, jp,
                                       jcfg)
    tp, ts, _ = adamw_update(_torch(g), ts, tp, cfg)
    _close(tp, jp)
    _close(ts.v, js.v)
    assert int(ts.step) == 2


def test_adamw_updates_in_place():
    p = _torch(_tree(np.random.default_rng(3)))
    before = {id(x) for x in jax.tree.leaves(p)}
    s = adamw_init(p)
    new, s2, _ = adamw_update(_torch(_tree(np.random.default_rng(4))), s, p,
                              AdamWConfig())
    assert new is p and {id(x) for x in jax.tree.leaves(new)} == before
    assert s2.m is s.m and s2.v is s.v


def test_adamw_converges_on_least_squares():
    rng = np.random.default_rng(0)
    d = 16
    A = torch.from_numpy(rng.normal(size=(d, d)) / np.sqrt(d)).float()
    b = torch.from_numpy(rng.normal(size=(d,))).float()
    params = {"w": torch.zeros(d)}

    def loss(w):
        return torch.mean((A @ w - b) ** 2)

    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=10,
                      total_steps=10_000, min_lr_frac=0.5)
    state = adamw_init(params)
    l0 = float(loss(params["w"]))
    for _ in range(1000):
        w = params["w"].clone().requires_grad_()
        loss(w).backward()
        params, state, _ = adamw_update({"w": w.grad}, state, params, cfg)
    assert float(loss(params["w"])) < 0.05 * l0


def test_grad_clip_bounds_update():
    p = {"w": torch.zeros(16)}
    g = {"w": torch.full((16,), 3.0)}
    old = p["w"].clone()
    new, _, m = adamw_update(g, adamw_init(p), p,
                             AdamWConfig(lr=1.0, grad_clip=1e-6,
                                         weight_decay=0.0))
    assert float(m["grad_norm"]) > 1e-6           # the unclipped norm
    assert float(torch.linalg.vector_norm(new["w"] - old)) < 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_gradients_bit_for_bit(seed):
    """Two steps from a zero residual, then one from the reference's own
    residual: dequantized gradients and residuals equal bit for bit, ef_l1
    within 1e-6 (a sum over leaves)."""
    rng = np.random.default_rng(seed)
    jstate = jax_comp.compression_init(jax.tree.map(jnp.asarray,
                                                    _tree(rng)))
    tstate = compression_init(_torch(_tree(rng)))
    for _ in range(2):
        g = _tree(rng, scale=rng.uniform(1e-4, 10))
        jg, jstate, jm = jax_comp.compress_gradients(
            jax.tree.map(jnp.asarray, g), jstate)
        tg, tstate, tm = compress_gradients(_torch(g), tstate)
        for a, b in zip(jax.tree.leaves(state_to_numpy(tg)),
                        jax.tree.leaves(jg)):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(jax.tree.leaves(state_to_numpy(tstate.residual)),
                        jax.tree.leaves(jstate.residual)):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_allclose(float(tm["ef_l1"]), float(jm["ef_l1"]),
                                   rtol=1e-6)
    tstate = compression_state_from_numpy(
        jax.tree.map(np.asarray, jstate.residual), "cpu")
    g = _tree(rng)
    jg, _, _ = jax_comp.compress_gradients(jax.tree.map(jnp.asarray, g),
                                           jstate)
    tg, _, _ = compress_gradients(_torch(g), tstate)
    for a, b in zip(jax.tree.leaves(state_to_numpy(tg)), jax.tree.leaves(jg)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_quantize_rounds_half_to_even():
    """With a largest magnitude of 127 the scale is 1, so the quotients are
    the halves themselves: 0.5 and -0.5 round to 0, 1.5 and 2.5 to 2."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5])
    q, scale = _quantize_int8(x)
    assert float(scale) == 1.0
    jq, _ = jax_comp._quantize_int8(jnp.asarray(x.numpy()))
    assert q.tolist() == np.asarray(jq).tolist() == [127, 0, 2, 2, 0, -2]


def test_compression_error_feedback_telescopes():
    """sum(dequantized) + final residual == sum(raw grads)."""
    params = {"w": torch.zeros(64)}
    state = compression_init(params)
    rng = np.random.default_rng(1)
    total_raw, total_deq = torch.zeros(64), torch.zeros(64)
    for _ in range(20):
        g = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
        total_raw += g["w"]
        deq, state, _ = compress_gradients(g, state)
        total_deq += deq["w"]
    np.testing.assert_allclose((total_deq + state.residual["w"]).numpy(),
                               total_raw.numpy(), atol=1e-4)


def test_payload_bytes_matches_jax():
    tree = _tree(np.random.default_rng(0))
    for compressed in (False, True):
        assert payload_bytes(_torch(tree), compressed) == \
            jax_comp.payload_bytes(jax.tree.map(jnp.asarray, tree),
                                   compressed)
