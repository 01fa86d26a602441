"""The port's attention against the JAX package's, on the CPU.

On the CPU the port's ``flash_attention`` runs its plain PyTorch version;
it is held to JAX's ``attention_reference`` over the grid of
``test_kernels.py::test_flash_attention_sweep`` and to JAX's Pallas kernel
in interpret mode on a few cases.  The CUDA kernel itself is held to the
plain version on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``).  The port's ``blockwise_attention`` and
``decode_attention`` are held to JAX's.

Tolerances: f32 atol = rtol = 2e-5 (the two einsums sum in another order);
bf16 2e-2, as in ``test_kernels.py``.  Inputs are made in f32 with numpy
and rounded to bf16 by each framework (both round to nearest even, so both
see the same bf16 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_reference
from repro.models import attention as jax_attn
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention as port_attn

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SWEEP = [
    (2, 256, 256, 4, 2, 64),
    (1, 128, 384, 8, 8, 128),
    (2, 200, 200, 4, 1, 64),     # unaligned seq
    (1, 1, 256, 8, 2, 64),       # decode-style single query
    (2, 64, 512, 4, 4, 32),
]
MASKS = [(True, None), (True, 96), (False, None)]


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    jdt, tdt, tol = DTYPES[dtype]
    arrs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs], tol)


def _close(port, jax_out, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_sweep_matches_jax_reference(B, Sq, Sk, H, KV, hd,
                                                     dtype, causal, window):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(
        Sq * 7 + Sk + hd, [(B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)],
        dtype)
    qoff = Sk - Sq if Sq <= Sk else 0
    before = ops.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              q_offset=qoff)
    assert ops.flash_attention.launches == before   # no kernel on the CPU
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, attention_reference(jq, jk, jv, causal=causal,
                                    window=window, q_offset=qoff), tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (2, 200, 200, 4, 1, 64, True, None),
    (1, 128, 384, 8, 2, 32, True, 96),
    (2, 64, 256, 6, 2, 80, False, None),
])
def test_flash_attention_matches_jax_pallas_interpret(B, Sq, Sk, H, KV, hd,
                                                      causal, window):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(
        3, [(B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)], "float32")
    qoff = Sk - Sq
    want = jax_flash(jq, jk, jv, causal=causal, window=window, q_offset=qoff,
                     block_q=64, block_k=64, interpret=True)
    _close(ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                               q_offset=qoff), want, tol)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
                            torch.zeros(1, 8, 2, 48))
    with pytest.raises(ValueError, match="H % KV"):
        ops.flash_attention(torch.zeros(1, 8, 3, 64), k, k)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, k, q_offset=-1)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="sees no key"):
        ops.flash_attention(q, k, k, q_offset=20, window=4)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,window,qoff,block", [
    (2, 96, 96, 4, 2, 32, None, 0, 32),
    (1, 70, 70, 6, 3, 16, 24, 0, 32),      # ragged tiles, window
    (2, 40, 104, 4, 1, 32, None, 64, 32),  # q_offset: a chunk after a cache
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_blockwise_attention_matches_jax(B, Sq, Sk, H, KV, hd, window, qoff,
                                         block, dtype):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(
        Sk + hd, [(B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)], dtype)
    valid = np.arange(Sk) < Sk - 5               # a cache-fill mask
    kw = dict(causal=True, window=window, q_offset=qoff, block_q=block,
              block_k=block)
    want = jax_attn.blockwise_attention(jq, jk, jv, k_valid=jnp.asarray(valid),
                                        **kw)
    got = port_attn.blockwise_attention(tq, tk, tv,
                                        k_valid=torch.from_numpy(valid), **kw)
    assert got.dtype == tq.dtype
    _close(got, want, tol)


@pytest.mark.parametrize("S,H,KV,hd,pos,window", [
    (48, 4, 2, 32, 30, None),
    (48, 8, 2, 64, 47, 16),
    (20, 4, 4, 32, 0, None),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_matches_jax(S, H, KV, hd, pos, window, dtype):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(
        S + pos, [(2, 1, H, hd), (2, S, KV, hd), (2, S, KV, hd)], dtype)
    want = jax_attn.decode_attention(jq, jk, jv, pos=jnp.int32(pos),
                                     window=window)
    got = port_attn.decode_attention(tq, tk, tv, pos=pos, window=window)
    _close(got, want, tol)
