"""The port's MoE layer against the JAX package's, on the CPU.

Reduced mixtral-8x7b (4 experts, top-2) and llama4-scout-17b-a16e (4
experts, top-1, a shared expert), f32, layer 0 of the seeded numpy
weights, skewed N(0, 1) tokens from numpy (``_x``).  ``apply_moe`` over
S = 1, 24, 80, 2,049, 3,000 and 4,096 (1, 1, 1, 1, 4 and 4 dispatch
groups): y within
atol = rtol = 2e-5 (the expert products sum in another order), the
experts picked and the slots kept equal to the JAX package's routing, the
balance loss within rtol 1e-6.  At S = 24 the capacity drops slots, and
the test says so.  Gradients within atol 1e-5 + rtol 1e-4 of
``jax.grad``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as tl
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import moe as jax_moe
from repro.models.api import get_model as jax_get_model
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import serve_batch
from repro_torch.models import layers, moe

ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
SIZES = [1, 24, 80, 2049, 3000, 4096]
B = 2


def _layer0(arch, **over):
    """(JAX config, port config, layer 0's moe leaves as numpy)."""
    jcfg, cfg = tl.configs(arch, **over)
    tree = tl.weights(arch)["blocks"]["moe"]
    return jcfg, cfg, jax.tree.map(lambda a: np.asarray(a[0]), tree)


def _x(cfg, S, seed=0, batch=B):
    """N(0, 1) tokens plus one N(0, 1) vector shared by a row's tokens:
    the shared part skews the routing, as a model's hidden states are
    skewed, so that the capacity binds."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, S, cfg.d_model), dtype=np.float32)
    return x + rng.standard_normal((batch, 1, cfg.d_model), dtype=np.float32)


def _jax_routing(p, x, jcfg):
    """The JAX package's experts and kept slots, from its own top-k: a
    slot's position is its rank among the slots of its (row, group) sent
    to the same expert, in (token, k) order."""
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x),
                                      jnp.asarray(p["router"])), axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.top_k)
    idx = np.asarray(idx)
    Bb, S, K = idx.shape
    nG = moe.n_groups(S)
    C = jax_moe._capacity(S // nG, jcfg)
    kept = np.zeros_like(idx, dtype=bool)
    for b in range(Bb):
        for g in range(nG):
            flat = idx[b, g * (S // nG):(g + 1) * (S // nG)].reshape(-1)
            seen = np.zeros(jcfg.n_experts, int)
            keep = np.zeros(flat.shape, bool)
            for t, e in enumerate(flat):
                keep[t] = seen[e] < C
                seen[e] += 1
            kept[b, g * (S // nG):(g + 1) * (S // nG)] = keep.reshape(-1, K)
    return idx, kept


def test_group_count_and_capacity():
    """The group count doubles while it divides S and a group is longer
    than 1,024 tokens; C is the capacity of one group."""
    assert {S: moe.n_groups(S) for S in (1, 24, 1024, 2048, 2049, 3000,
                                         4096, 6144)} == {
        1: 1, 24: 1, 1024: 1, 2048: 2, 2049: 1, 3000: 4, 4096: 4, 6144: 8}
    _, cfg = tl.configs("mixtral-8x7b")
    for S in (1, 15, 24, 750, 1024):
        assert moe._capacity(S, cfg) == jax_moe._capacity(S, cfg)
    assert moe._capacity(24, cfg) == 15


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, S):
    jcfg, cfg, p = _layer0(arch)
    x = _x(cfg, S, seed=S)
    want, want_aux = jax_moe.apply_moe(jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x), jcfg)
    with moe.recording() as rec:
        got, aux = moe.apply_moe(tl.torch_tree(p), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    idx, kept = _jax_routing(p, x, jcfg)
    r, = rec
    np.testing.assert_array_equal(r["gate_idx"].numpy(), idx)
    np.testing.assert_array_equal(r["kept"].numpy(), kept)
    if S == 24:      # the golden sizes drop slots in both packages
        assert not kept.all()


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_take_the_lower_index(arch):
    """Equal router columns give equal probabilities, and top-k takes the
    lower index first, as ``lax.top_k`` does: an all-zero router picks
    experts 0 (and 1); with columns 1 and 3 equal to w and 0 and 2 equal
    to -w, a token with x.w > 0 picks 1 (and 3), else 0 (and 2)."""
    jcfg, cfg, p = _layer0(arch)
    x = _x(cfg, 24, seed=3)
    w = np.random.default_rng(4).standard_normal(cfg.d_model).astype(
        np.float32)
    for router in (np.zeros_like(p["router"]),
                   np.stack([-w, w, -w, w], axis=1)):
        q = dict(p, router=router)
        want, _ = jax_moe.apply_moe(jax.tree.map(jnp.asarray, q),
                                    jnp.asarray(x), jcfg)
        with moe.recording() as rec:
            got, _ = moe.apply_moe(tl.torch_tree(q), torch.from_numpy(x), cfg)
        idx, _ = _jax_routing(q, x, jcfg)
        pos = (x @ router)[..., 1] > 0
        low = np.where(pos[..., None], [1, 3][:cfg.top_k], [0, 2][:cfg.top_k])
        expect = (np.broadcast_to([0, 1][:cfg.top_k], idx.shape)
                  if not router.any() else low)
        np.testing.assert_array_equal(idx, expect)
        np.testing.assert_array_equal(rec[0]["gate_idx"].numpy(), expect)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_drop_matches_dense_mixture(arch):
    """With a capacity that drops nothing, the layer is the explicit top-k
    mixture (the oracle of tests/test_models.py), plus the shared
    expert."""
    _, cfg, p = _layer0(arch, capacity_factor=8.0)
    x = torch.from_numpy(_x(cfg, 80, seed=5))
    tp = tl.torch_tree(p)
    with moe.recording() as rec:
        y, aux = moe.apply_moe(tp, x, cfg)
    assert bool(rec[0]["kept"].all()) and float(aux) > 0
    probs = torch.softmax(x @ tp["router"], dim=-1)
    gv, gi = torch.topk(probs, cfg.top_k)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = x @ tp["wi"][e]
        g = x @ tp["wg"][e]
        o = (torch.nn.functional.silu(g) * h) @ tp["wo"][e]
        want += torch.where(gi == e, gv, 0.0).sum(-1, keepdim=True) * o
    if cfg.n_shared_experts:
        want += layers.apply_mlp(tp["shared"], x, cfg)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forcing_routes_to_the_given_experts(arch):
    """Under ``moe.forcing`` a call takes the given experts, its gates
    read off its own probabilities there: its own recorded routing gives
    the same output bit for bit (and the same dropped slots at S = 24);
    other experts give their top-k mixture, at a capacity that drops
    nothing."""
    _, cfg, p = _layer0(arch)
    tp = tl.torch_tree(p)
    x = torch.from_numpy(_x(cfg, 24, seed=8))
    with moe.recording() as rec:
        y, _ = moe.apply_moe(tp, x, cfg)
    with moe.forcing([r["gate_idx"] for r in rec]), moe.recording() as again:
        y2, _ = moe.apply_moe(tp, x, cfg)
    assert torch.equal(y, y2) and not bool(rec[0]["kept"].all())
    assert torch.equal(again[0]["kept"], rec[0]["kept"])

    _, cf, _ = _layer0(arch, capacity_factor=8.0)
    other = cfg.n_experts - 1 - rec[0]["gate_idx"]
    with moe.forcing([other]), moe.recording() as forced:
        y3, _ = moe.apply_moe(tp, x, cf)
    assert torch.equal(forced[0]["gate_idx"], other)
    probs = torch.softmax(x @ tp["router"], dim=-1)
    gv = probs.gather(-1, other)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        o = (torch.nn.functional.silu(x @ tp["wg"][e])
             * (x @ tp["wi"][e])) @ tp["wo"][e]
        want += torch.where(other == e, gv, 0.0).sum(-1, keepdim=True) * o
    if cfg.n_shared_experts:
        want += layers.apply_mlp(tp["shared"], x, cfg)
    np.testing.assert_allclose(y3.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_grads_match_jax(arch):
    """d(sum(y * c) + aux) by x, the router, the experts and the shared
    expert, at S = 24, where slots drop."""
    jcfg, cfg, p = _layer0(arch)
    x = _x(cfg, 24, seed=6)
    c = np.random.default_rng(7).standard_normal(x.shape, dtype=np.float32)

    def jax_f(p, x):
        y, aux = jax_moe.apply_moe(p, x, jcfg)
        return jnp.sum(y * jnp.asarray(c)) + aux

    want_p, want_x = jax.grad(jax_f, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(lambda t: t.requires_grad_(), tl.torch_tree(p))
    tx = torch.from_numpy(x).requires_grad_()
    with moe.recording() as rec:
        y, aux = moe.apply_moe(tp, tx, cfg)
    assert not bool(rec[0]["kept"].all())
    (torch.sum(y * torch.from_numpy(c)) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x),
                               atol=1e-5, rtol=1e-4)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_p)[0]:
        got = tp
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(leaf),
                                   atol=1e-5, rtol=1e-4, err_msg=str(path))


def test_jax_serve_batch_parts_from_its_prefill_and_decode():
    """Why the port's moe tokens are held to the JAX package's prefill and
    decode_step, and not to its serve_batch: the latter feeds the prompt
    through decode steps, each routing one token with nothing dropped,
    while a full-sequence prefill drops slots (reduced mixtral, seed 0,
    24-token prompts, the JAX package's own init).  The two JAX paths part
    from the first generated token on; the port's serve_batch follows the
    prefill path."""
    jcfg, cfg = tl.configs("mixtral-8x7b")
    jp = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    via_decode, _ = jax_serve_batch(jcfg, B, 24, 8, seed=0)
    via_prefill = tl.jax_prefill_decode(jcfg, jp, tl.prompts(cfg, B, 24, 0),
                                        8)
    via_decode = np.asarray(via_decode)
    assert (via_decode[:, :24] == via_prefill[:, :24]).all()
    assert (via_decode[:, 24] != via_prefill[:, 24]).all()
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got, _ = serve_batch(dataclasses.replace(cfg, use_pallas=True), B, 24, 8,
                         seed=0, params=params, device="cpu")
    np.testing.assert_array_equal(got.numpy(), via_prefill)
