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

from _hypothesis_compat import given, settings, st

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


# ---- the sm90 kernel's tile schedule, dtype route and TMA checks ----

def _visible(Sq, Sk, q_offset, causal, window):
    """The reference's mask (``ref.py``), [Sq, Sk] bool, built the same way."""
    q_pos = q_offset + np.arange(Sq)[:, None]
    k_pos = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), dtype=bool)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    return mask


def _assert_plan_covers_mask(Sq, Sk, q_offset, causal, window, bq, bk):
    """The plan against a brute-force mask: no visible key outside a query
    tile's range, no tile in the range without a visible key (so no skipped
    tile holds one and none visited is wasted), and every tile marked
    unmasked fully visible to every live row, keys below Sk only."""
    mask = _visible(Sq, Sk, q_offset, causal, window)
    plan = ops._kv_tile_plan(Sq, Sk, q_offset, causal, window, block_q=bq,
                             block_k=bk)
    assert len(plan) == -(-Sq // bq)
    n_kt = -(-Sk // bk)
    for qt, (lo, hi, masked) in enumerate(plan):
        rows = mask[qt * bq:(qt + 1) * bq]          # the live rows only
        assert 0 <= lo <= hi <= n_kt and len(masked) == hi - lo
        seen = rows.any(axis=0)
        keys = np.flatnonzero(seen)
        assert keys.size, "a live row sees no key"
        assert lo * bk <= keys[0] and keys[-1] < hi * bk
        for t in range(lo, hi):
            tile = rows[:, t * bk:(t + 1) * bk]
            assert tile.any(), f"tile {t} of query tile {qt} holds no key"
            if not masked[t - lo]:
                assert (t + 1) * bk <= Sk and tile.all(), (qt, t)


@settings(max_examples=300, deadline=None)
@given(Sq=st.integers(1, 600), Sk=st.integers(1, 600),
       q_offset=st.integers(-300, 700), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 700)),
       bq=st.sampled_from([16, 32, 128]), bk=st.sampled_from([16, 32, 128]))
def test_property_kv_tile_plan_matches_brute_force_mask(Sq, Sk, q_offset,
                                                        causal, window, bq,
                                                        bk):
    try:   # only what the wrapper accepts reaches the kernel
        ops._check_rows_see_keys(Sq, Sk, causal, window, q_offset)
    except ValueError:
        return
    _assert_plan_covers_mask(Sq, Sk, q_offset, causal, window, bq, bk)


@pytest.mark.parametrize("Sq,Sk,q_offset,causal,window", [
    (2048, 2048, 0, True, None),      # the llama serve shape
    (4608, 4608, 0, True, 4096),      # h2o-danube-1.8b's window cuts tiles
    (2049, 2049, 0, True, None),      # one key past a tile
    (77, 2049, 1972, True, 96),       # a chunk after a cache, windowed
    (1, 256, 255, True, None),        # one query
    (300, 300, 0, False, None),       # full attention, ragged
    (200, 500, -100, False, 150),     # non-causal window, negative offset
])
def test_kv_tile_plan_cases(Sq, Sk, q_offset, causal, window):
    _assert_plan_covers_mask(Sq, Sk, q_offset, causal, window, 128, 128)


def test_kv_tile_plan_serve_shape_visits_the_causal_triangle():
    plan = ops._kv_tile_plan(2048, 2048, 0, True, None)
    # query tile i visits key tiles 0..i, masks only the diagonal one
    assert plan == [(0, i + 1, [False] * i + [True]) for i in range(16)]
    danube = ops._kv_tile_plan(4608, 4608, 0, True, 4096)
    assert danube[-1][:2] == (3, 36)      # keys 513..4607 for the last tile
    assert danube[-1][2][0] and danube[-1][2][-1]   # window edge, diagonal
    assert sum(sum(1 for m in p[2] if not m) for p in danube) > 0


def test_flash_route_follows_the_dtype():
    assert ops.ROUTES == {torch.bfloat16: "sm90_bf16", torch.float32: "f32"}
    assert set(ops.flash_attention.launches_by_route) == {"sm90_bf16", "f32"}
    for dt in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 8, 4, 64, dtype=dt)
        k = torch.zeros(1, 8, 2, 64, dtype=dt)
        before = dict(ops.flash_attention.launches_by_route)
        total = ops.flash_attention.launches
        out = ops.flash_attention(q, k, k)
        # the CPU takes the plain version: no route counts a launch
        assert out.dtype == dt
        assert ops.flash_attention.launches_by_route == before
        assert ops.flash_attention.launches == total


def test_flash_reset_launches_zeroes_every_count():
    ops.flash_attention.launches = 5
    ops.flash_attention.launches_by_route["f32"] = 3
    ops.reset_launches()
    assert ops.flash_attention.launches == 0
    assert ops.flash_attention.launches_by_route == {"sm90_bf16": 0, "f32": 0}


def test_tma_view_takes_contiguous_and_strided_bf16():
    x = torch.zeros(2, 8, 4, 80, dtype=torch.bfloat16)
    y, strides = ops._tma_view(x, "q")
    assert y is x and strides == [8 * 4 * 80, 4 * 80, 80]
    # a [B, S, H, hd] view of a [B, H, S, hd] tensor: strides passed as they are
    t = torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16).transpose(1, 2)
    y, strides = ops._tma_view(t, "k")
    assert y.data_ptr() == t.data_ptr() and strides == [4 * 8 * 64, 64, 8 * 64]
    # dims of size 1 are never stepped: their strides need not be aligned
    one = torch.zeros(1, 1, 1, 32, dtype=torch.bfloat16)
    assert ops._tma_view(one, "q")[1] == [32, 32, 32]
    # a last dim that is not contiguous is copied
    w = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16).transpose(2, 3)
    w = w.reshape(1, 8, 64, 2).transpose(2, 3)
    y, strides = ops._tma_view(w, "v")
    assert y.is_contiguous() and strides == [8 * 2 * 64, 2 * 64, 64]


def test_tma_view_raises_on_what_tma_does_not_take():
    flat = torch.zeros(8 * 4 * 64 + 1, dtype=torch.bfloat16)
    misaligned = flat[1:].view(1, 8, 4, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._tma_view(misaligned, "q")
    # rows of 68 bf16: the head stride is 136 bytes
    odd = torch.zeros(1, 8, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        ops._tma_view(odd, "k")
    # a sequence stride of 2 * 64 + 4 elements (264 bytes)
    rows = torch.zeros(1, 8, 2 * 64 + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dim 1"):
        ops._tma_view(rows.as_strided((1, 8, 2, 64), (8 * 132, 132, 64, 1)),
                      "v")
