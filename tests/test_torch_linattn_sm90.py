"""The sm90 linattn kernel's arithmetic against the JAX package, on the CPU.

``csrc/linattn_scan_sm90.cu`` cannot run here (no nvcc, no card), so its
arithmetic is stated in plain PyTorch, rounded where the kernel rounds
(``ref.py::linattn_sm90_reference``): chunks of 64 steps, sub-chunks of
16 whose cross pairs factor through the source sub-chunk's last step, exact
diagonal sub-blocks, bf16 operands of every tensor-core product and the
hi/lo split of the state update.  That statement is held here to JAX's
``linattn_reference`` and to JAX's Pallas kernel in interpret mode on the
same numpy-seeded inputs, with bf16 r/k/v as on the serve path, and its
final state to a scan of JAX's ``wkv_step``.  The kernel itself is held to
the plain version on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py`` phase 10).

Tolerances, as in ``test_kernels.py``: y within 5e-2 of the largest
reference entry (bf16), the f32 state within 1e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.kernels.linattn_scan.ops import linattn as jax_linattn
from repro.kernels.linattn_scan.ref import linattn_reference as jax_reference
from repro.models.rwkv import wkv_step as jax_wkv_step
from repro_torch.kernels import _build, _tma
from repro_torch.kernels.linattn_scan import ops
from repro_torch.kernels.linattn_scan.ref import (linattn_reference,
                                                  linattn_sm90_reference)

Y_TOL, STATE_TOL = 5e-2, 1e-4
# test_kernels.py::test_linattn_sweep's (B, H, S, chunk), at the sm90
# kernel's key dims
SWEEP = [(B, H, S, K, chunk)
         for B, H, S, chunk in ((2, 3, 64, 16), (1, 2, 128, 32),
                                (2, 1, 100, 32), (1, 4, 256, 128))
         for K in (64, 128)]


def _logw(rng, shape, kind):
    """f32 log decays (< 0): the sweep's -exp(N(0, 0.5^2)), a constant, or
    "mixed": each channel's own scale, from -30 a step to -1e-6."""
    if kind is None:
        return -np.exp(rng.standard_normal(shape, dtype=np.float32) * 0.5)
    if kind == "mixed":
        scale = np.exp(rng.uniform(np.log(1e-6), np.log(30.0), shape[-1]))
        jitter = np.exp(rng.standard_normal(shape) * 0.3)
        return (-scale * jitter).astype(np.float32)
    return np.full(shape, kind, np.float32)


def _inputs(B, H, S, K, seed, logw=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, K), dtype=np.float32) * 0.5
               for _ in range(3))
    u = rng.standard_normal((H, K), dtype=np.float32) * 0.5
    return r, k, v, _logw(rng, (B, H, S, K), logw), u


def _both(arrs):
    """(JAX arrays, torch tensors): r, k, v in bf16, logw and u in f32."""
    r, k, v, lw, u = arrs
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in (r, k, v)]
            + [jnp.asarray(lw), jnp.asarray(u)],
            [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
            + [torch.from_numpy(lw), torch.from_numpy(u)])


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


@jax.jit
def _jax_state(r, k, v, logw, u):
    """The final state of a scan of JAX's ``wkv_step``, key axis first."""
    B, H, S, K = r.shape

    def step(state, x):
        _, state = jax_wkv_step(*x, u, state)
        return state, None

    xs = tuple(a.astype(jnp.float32).transpose(2, 0, 1, 3)
               for a in (r, k, v, logw))
    state, _ = jax.lax.scan(step, jnp.zeros((B, H, K, K), jnp.float32), xs)
    return state


def _check(arrs, jax_kernel_chunk=None):
    (jr, jk, jv, jw, ju), t = _both(arrs)
    stats = {}
    y, state = linattn_sm90_reference(*t, stats=stats)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    assert stats["max_exponent"] <= 0.0
    assert _rel(y, jax_reference(jr, jk, jv, jw, ju)) < Y_TOL
    assert _rel(state, _jax_state(jr, jk, jv, jw, ju)) < STATE_TOL
    if jax_kernel_chunk is not None:
        want = jax_linattn(jr, jk, jv, jw, ju, chunk=jax_kernel_chunk,
                           interpret=True)
        assert _rel(y, want) < Y_TOL
    return y, state


@pytest.mark.parametrize("B,H,S,K,chunk", SWEEP)
def test_sm90_arithmetic_matches_jax_over_the_sweep(B, H, S, K, chunk):
    _check(_inputs(B, H, S, K, seed=S + K), jax_kernel_chunk=chunk)


@pytest.mark.parametrize("S,K,logw", [
    (256, 64, -6.0),                  # steep: 96 steps of decay overflow exp(+E)
    (77, 128, -30.0),                 # steeper than the model's live w0
    (2045, 64, -float(np.exp(-6.0))),  # slow: the state lives long, ragged
    (300, 128, "mixed"),              # every channel its own decay
    (33, 64, "mixed"),                # one chunk, ragged
])
def test_sm90_arithmetic_holds_steep_slow_and_mixed_decays(S, K, logw):
    _check(_inputs(1, 2, S, K, seed=S, logw=logw),
           jax_kernel_chunk=64 if S < 1000 else None)


def test_sm90_arithmetic_equals_the_plain_version_within_tolerance():
    """The plain version (a token scan) is what the card holds the kernel
    to: the kernel's arithmetic meets it at the serve path's tolerances."""
    t = _both(_inputs(2, 3, 130, 64, seed=5))[1]
    y, state = linattn_sm90_reference(*t)
    wy, wstate = linattn_reference(*t)
    assert _rel(y, wy.float()) < Y_TOL and _rel(state, wstate) < STATE_TOL


@pytest.mark.parametrize("lo,hi,seed", [(-40.0, -30.0, 0), (-1e-6, -1e-6, 1),
                                        (-40.0, -1e-6, 2), (-2.0, -0.5, 3)])
def test_every_exponent_is_at_most_zero(lo, hi, seed):
    """For decays anywhere in [-40, -1e-6] a step, every exponent the
    kernel forms is <= 0 and every output finite."""
    rng = np.random.default_rng(seed)
    B, H, S, K = 1, 2, 97, 64
    r, k, v, _, u = _inputs(B, H, S, K, seed)
    logw = -np.exp(rng.uniform(np.log(-hi), np.log(-lo), (B, H, S, K)))
    stats = {}
    y, state = linattn_sm90_reference(*_both(
        (r, k, v, logw.astype(np.float32), u))[1], stats=stats)
    assert stats["max_exponent"] <= 0.0
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       a=st.floats(-40.0, -1e-6), b=st.floats(-40.0, -1e-6),
       S=st.integers(1, 140))
def test_property_exponents_at_most_zero_and_outputs_finite(seed, a, b, S):
    lo, hi = min(a, b), max(a, b)
    rng = np.random.default_rng(seed)
    r, k, v, _, u = _inputs(1, 1, S, 64, seed)
    logw = -np.exp(rng.uniform(np.log(-hi), np.log(-lo), (1, 1, S, 64)))
    stats = {}
    y, state = linattn_sm90_reference(*_both(
        (r, k, v, logw.astype(np.float32), u))[1], stats=stats)
    assert stats["max_exponent"] <= 0.0
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()


@pytest.mark.parametrize("dtype,K,want", [
    (torch.bfloat16, 64, "sm90_bf16"), (torch.bfloat16, 128, "sm90_bf16"),
    (torch.bfloat16, 16, "cuda_core"), (torch.bfloat16, 32, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core"),
])
def test_route_by_dtype_and_key_dim(dtype, K, want):
    assert ops.route(dtype, K) == want


def test_both_sources_are_built():
    assert {ops.SOURCE, ops.SM90_SOURCE} <= set(_build.SOURCES)


def test_cpu_takes_the_plain_version_whatever_the_dtype():
    """bf16 at K = 64 on the CPU is the plain token scan, and no route
    counts a launch."""
    t = _both(_inputs(1, 2, 70, 64, seed=9))[1]
    ops.reset_launches()
    y, state = ops.linattn(*t, return_state=True)
    wy, wstate = linattn_reference(*t)
    assert torch.equal(y, wy) and torch.equal(state, wstate)
    assert ops.linattn.launches == 0
    assert ops.linattn.launches_by_route == {"sm90_bf16": 0, "cuda_core": 0}


def test_reset_launches_zeroes_every_count():
    ops.linattn.launches = 4
    ops.linattn.launches_by_route["sm90_bf16"] = 3
    ops.reset_launches()
    assert ops.linattn.launches == 0
    assert ops.linattn.launches_by_route == {"sm90_bf16": 0, "cuda_core": 0}


def test_tma_view_of_the_model_layout():
    """The model's [B, H, S, K] view of [B, S, H, K]: read in place, with
    (batch, head, time) strides; a misaligned base or a stride that is no
    multiple of 16 bytes raises."""
    B, S, H, K = 2, 40, 3, 64
    x = torch.zeros((B, S, H, K), dtype=torch.bfloat16).transpose(1, 2)
    view, strides = _tma.tma_view(x, "r")
    assert view.data_ptr() == x.data_ptr()
    assert strides == [S * H * K, K, H * K]
    flat = torch.zeros(B * S * H * K + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _tma.tma_view(flat[1:].view(B, S, H, K).transpose(1, 2), "k")
    odd = torch.zeros((B, H, S, K + 4), dtype=torch.bfloat16)[..., :K]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        _tma.tma_view(odd, "v")


@pytest.mark.parametrize("change,err", [
    (dict(K=48), ValueError),
    (dict(r_dtype=torch.float16), TypeError),
    (dict(u_dtype=torch.bfloat16), TypeError),
    (dict(lw_dtype=torch.float16), TypeError),
])
def test_op_refuses_what_neither_kernel_takes(change, err):
    K = change.get("K", 64)
    r = torch.zeros((1, 2, 8, K), dtype=change.get("r_dtype", torch.bfloat16))
    lw = torch.full((1, 2, 8, K), -1.0,
                    dtype=change.get("lw_dtype", torch.float32))
    u = torch.zeros((2, K), dtype=change.get("u_dtype", torch.float32))
    with pytest.raises(err):
        ops.linattn(r, r, r, lw, u)
