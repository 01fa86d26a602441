"""The port's chunked linear attention against the JAX package's, on the CPU.

On the CPU the port's ``linattn`` runs its plain PyTorch version, a
token-by-token scan (``ref.py``); it is held to JAX's
``linattn_reference`` and to JAX's Pallas kernel in interpret mode
(``ops.linattn(..., interpret=True)``) over the grid of
``test_kernels.py::test_linattn_sweep`` and its steep-decay case, and its
final state to a token-by-token loop of JAX's ``wkv_step``.  The CUDA
kernel itself is held to the plain version on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Tolerances, as in ``test_kernels.py``: the largest error relative to the
largest reference entry under 1e-4 in f32 (the same recurrence, summed in
another order, or in chunks) and under 5e-2 in bf16 (y is rounded to bf16
by each framework).  States are f32 in both dtypes and held to 1e-4 of
the largest state entry.  Inputs are made in f32 with numpy and rounded to
bf16 by each framework (both round to nearest even).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linattn_scan.ops import linattn as jax_linattn
from repro.kernels.linattn_scan.ref import linattn_reference as jax_reference
from repro.models.rwkv import wkv_step as jax_wkv_step
from repro_torch.kernels.linattn_scan import ops
from repro_torch.kernels.linattn_scan.ref import linattn_reference

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
SWEEP = [
    (2, 3, 64, 16, 16),
    (1, 2, 128, 64, 32),
    (2, 1, 100, 32, 32),     # unaligned -> the ragged last tile
    (1, 4, 256, 64, 128),    # long chunk: stability regression case
]
STATE_TOL = 1e-4


def _inputs(B, H, S, K, seed, *, logw=None):
    """r, k, v, logw [B, H, S, K] and u [H, K], f32 numpy, the JAX sweep's
    distributions: r/k/v/u ~ N(0, 0.5^2), logw = -exp(N(0, 0.5^2))."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, K), dtype=np.float32) * 0.5
               for _ in range(3))
    if logw is None:
        logw = -np.exp(rng.standard_normal((B, H, S, K), dtype=np.float32)
                       * 0.5)
    else:
        logw = np.full((B, H, S, K), logw, np.float32)
    u = rng.standard_normal((H, K), dtype=np.float32) * 0.5
    return r, k, v, logw.astype(np.float32), u


def _both(arrs, dtype):
    """(JAX arrays, torch tensors) of r, k, v, logw in ``dtype``, u in f32."""
    jdt, tdt, _ = DTYPES[dtype]
    *rkvw, u = arrs
    return ([jnp.asarray(a).astype(jdt) for a in rkvw] + [jnp.asarray(u)],
            [torch.from_numpy(a).to(tdt) for a in rkvw] + [torch.from_numpy(u)])


def _rel_err(port, want) -> float:
    want = np.asarray(want, np.float32)
    err = np.abs(port.float().numpy() - want).max()
    return float(err / (np.abs(want).max() + 1e-6))


def _jax_state(r, k, v, logw, u):
    """The final state of a token-by-token JAX ``wkv_step`` loop."""
    B, H, S, K = r.shape
    state = jnp.zeros((B, H, K, K), jnp.float32)
    for t in range(S):
        _, state = jax_wkv_step(r[:, :, t], k[:, :, t], v[:, :, t],
                                logw[:, :, t], u, state)
    return np.asarray(state)


@pytest.mark.parametrize("B,H,S,K,chunk", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reference_matches_jax_reference(B, H, S, K, chunk, dtype):
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = _both(
        _inputs(B, H, S, K, seed=S + K), dtype)
    y, state = linattn_reference(tr, tk, tv, tw, tu)
    want = jax_reference(jr, jk, jv, jw, ju)
    assert y.dtype == tr.dtype and y.shape == (B, H, S, K)
    assert state.dtype == torch.float32 and state.shape == (B, H, K, K)
    assert _rel_err(y, want) < DTYPES[dtype][2]


@pytest.mark.parametrize("B,H,S,K,chunk", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_op_on_cpu_matches_jax_kernel(B, H, S, K, chunk, dtype):
    """The port's op (its plain version on the CPU) against the Pallas
    kernel in interpret mode, at the sweep's chunk lengths."""
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = _both(
        _inputs(B, H, S, K, seed=S * 3 + K), dtype)
    before = ops.linattn.launches
    y = ops.linattn(tr, tk, tv, tw, tu, chunk=chunk)
    want = jax_linattn(jr, jk, jv, jw, ju, chunk=chunk, interpret=True)
    assert ops.linattn.launches == before      # no kernel on the CPU
    assert y.dtype == tr.dtype
    assert _rel_err(y, want) < DTYPES[dtype][2]


def test_steep_decay_matches_jax_kernel():
    """test_kernels.py::test_linattn_steep_decay_stability's case: logw =
    -6 everywhere, u = 0, one 256-step sequence in chunks of 128."""
    r, k, v, logw, _ = _inputs(1, 2, 256, 32, seed=7, logw=-6.0)
    u = np.zeros((2, 32), np.float32)
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = _both(
        (r, k, v, logw, u), "float32")
    y, state = ops.linattn(tr, tk, tv, tw, tu, chunk=128, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    want = jax_linattn(jr, jk, jv, jw, ju, chunk=128, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jax_reference(jr, jk, jv, jw, ju)), atol=1e-4)


@pytest.mark.parametrize("B,H,S,K,logw", [
    (2, 3, 40, 16, None),
    (1, 2, 70, 64, None),
    (1, 2, 96, 32, -np.exp(-6.0)),    # slow decay: the state lives long
    (1, 1, 33, 128, -6.0),            # steep decay
])
def test_final_state_matches_jax_wkv_step_loop(B, H, S, K, logw):
    """The state the op returns is the one JAX's decode recurrence leaves,
    key axis first: a transposed state would pass every y test."""
    (jr, jk, jv, jw, ju), (tr, tk, tv, tw, tu) = _both(
        _inputs(B, H, S, K, seed=B + H + S + K, logw=logw), "float32")
    _, state = ops.linattn(tr, tk, tv, tw, tu, return_state=True)
    want = _jax_state(jr, jk, jv, jw, ju)
    assert state.shape == (B, H, K, K)
    err = np.abs(state.numpy() - want).max()
    assert err <= STATE_TOL * np.abs(want).max(), err
    if K > 16:   # not symmetric: the transpose is a different state
        assert np.abs(state.numpy().swapaxes(-1, -2) - want).max() > 0.1


def test_bf16_logw_is_accepted():
    """logw may be bf16 while r/k/v are f32, as in the JAX sweep's cast."""
    r, k, v, logw, u = _inputs(1, 2, 48, 32, seed=11)
    t = [torch.from_numpy(a) for a in (r, k, v, logw, u)]
    t[3] = t[3].to(torch.bfloat16)
    y = ops.linattn(*t)
    want = jax_reference(*(jnp.asarray(a) for a in (r, k, v)),
                         jnp.asarray(logw).astype(jnp.bfloat16),
                         jnp.asarray(u))
    assert y.dtype == torch.float32
    assert _rel_err(y, want) < 1e-4


def test_op_reads_strided_views():
    """The model hands the op [B, H, S, K] views of [B, S, H, K] tensors."""
    r, k, v, logw, u = _inputs(2, 3, 50, 16, seed=13)
    dense = [torch.from_numpy(a) for a in (r, k, v, logw)]
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in dense]
    assert not views[0].is_contiguous()
    a = ops.linattn(*dense, torch.from_numpy(u), return_state=True)
    b = ops.linattn(*views, torch.from_numpy(u), return_state=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("change,err", [
    (dict(K=48), ValueError),               # key dim not instantiated
    (dict(r_dtype=torch.float16), TypeError),
    (dict(u_shape=(3, 16)), ValueError),
    (dict(u_dtype=torch.bfloat16), TypeError),
    (dict(k_shape=(1, 2, 10, 16)), ValueError),
    (dict(S=0), ValueError),
])
def test_op_refuses_what_the_kernel_does_not_take(change, err):
    K, S = change.get("K", 16), change.get("S", 12)
    dt = change.get("r_dtype", torch.float32)
    r = torch.zeros((1, 2, S, K), dtype=dt)
    k = torch.zeros(change.get("k_shape", (1, 2, S, K)), dtype=dt)
    u = torch.zeros(change.get("u_shape", (2, K)),
                    dtype=change.get("u_dtype", torch.float32))
    with pytest.raises(err):
        ops.linattn(r, k, r.clone(), r.float(), u)
