"""Shared by the moe, hybrid, vlm and encdec LM tests and the LM golden
file: configs, seeded weights, and the JAX package's request paths that
the port's moe, vlm and encdec tokens are held to.

The port's ``serve_batch`` prefills the whole prompt at once.  The JAX
package's ``serve_batch`` feeds the prompt through decode steps instead,
and for moe that is another function: a full-sequence dispatch routes
with a capacity and may drop tokens, while a decode step routes one token
and never drops.  So the port's moe tokens are held to
:func:`jax_prefill_decode`, the JAX package's own ``prefill`` followed by
its ``decode_step`` on the cache laid out as the port's
``launch/serve.py::_prefill_cache`` lays it.

The JAX ``serve_batch`` never draws a vlm's patches or an encoder-decoder's
source: its encdec decode steps read a cross-attention cache of zeros.  So
the port's vlm tokens are held to :func:`jax_prefill_decode` with the
patches (decoding at the positions after them), and its encdec tokens to
:func:`jax_encdec_decode`, the JAX ``decode_step`` over the prompt with the
cross cache made from the JAX ``encode``.  :func:`jax_inputs` draws a
request as the JAX package's input specs split one.
"""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.launch.serve as jax_serve
from repro.configs.base import get_config as jax_get_config
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro.models.api import ModelAPI
from repro.models.api import get_model as jax_get_model
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
from repro_torch.launch.serve import serve_batch
from repro_torch.models import moe

LIVE_SEED = 1


def configs(arch, **over):
    """(JAX config, port config) of a reduced arch."""
    return (jax_get_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def weights(arch, seed=0, fan_in=False):
    """Seeded numpy weights with the leaves that ``init`` leaves at zero or
    one drawn live (from ``LIVE_SEED``): the Mamba2 layers', the QK
    norms', an encoder-decoder's LayerNorms; with ``fan_in``, the attention
    at its true fan-in."""
    return numpy_lm_params(configs(arch)[1], seed, live_seed=LIVE_SEED,
                           fan_in=fan_in)


def prompts(cfg, batch, prompt_len, seed):
    """The prompts both packages' ``serve_batch`` draw from ``seed``."""
    return np.random.default_rng(seed).integers(
        1, cfg.vocab - 1, (batch, prompt_len)).astype(np.int32)


@contextlib.contextmanager
def jax_serve_with(params):
    """JAX's ``serve_batch`` with ``params`` in place of its own init."""

    @dataclasses.dataclass(frozen=True)
    class Fixed(ModelAPI):
        def init(self, key):
            return params

    real = jax_serve.get_model
    jax_serve.get_model = lambda cfg: Fixed(
        **{f.name: getattr(real(cfg), f.name)
           for f in dataclasses.fields(ModelAPI)})
    try:
        yield
    finally:
        jax_serve.get_model = real


def jax_inputs(cfg, batch, S, seed):
    """A request of S positions from ``np.random.default_rng(seed)``: the
    prompt tokens first, then, as ``repro.launch.specs`` splits a sequence,
    for vlm ``int(S * frontend_frac)`` patch embeddings before ``S - that``
    text tokens, for encdec ``S // 2`` source frames and ``S - S // 2``
    target tokens, f32 standard normals."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        front, name = int(S * cfg.frontend_frac), "patches"
    elif cfg.family == "encdec":
        front, name = S // 2, "src_embeds"
    else:
        front, name = 0, None
    out = {"tokens": rng.integers(1, cfg.vocab - 1,
                                  (batch, S - front)).astype(np.int32)}
    if front:
        out[name] = rng.standard_normal((batch, front, cfg.d_model),
                                        dtype=np.float32)
    return out


def jax_prefill_decode(jcfg, jparams, prompt, gen, patches=None):
    """Greedy tokens ``[B, P + gen]`` from the JAX package's ``prefill``
    and ``decode_step`` (dense, moe and vlm): the prefill's K/V laid into a
    ``cache_defs`` cache of ``n + P + gen`` positions, position p in slot p,
    or for a sliding-window ring shorter than the prompt the last C
    positions in slot p % C; n is the count of a vlm's ``patches``, which
    come before the prompt, so its decoding starts at position n + P."""
    B, P = prompt.shape
    batch = {"tokens": jnp.asarray(prompt)}
    if patches is not None:
        batch["patches"] = jnp.asarray(patches)
        P += patches.shape[1]
    total = P + gen
    last, kv = jax_lm.prefill(jparams, batch, jcfg)
    model = jax_get_model(jcfg)
    defs = model.cache_defs_fn(B, total)
    C = defs["k"].shape[2]
    pos = np.arange(max(P - C, 0), P)
    cache = {}
    for n in ("k", "v"):
        buf = np.zeros(defs[n].shape, np.dtype(defs[n].dtype))
        buf[:, :, pos % C] = np.asarray(kv[n])[:, :, pos]
        cache[n] = jnp.asarray(buf)
    decode = jax.jit(model.decode_step)
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)
    out = [np.asarray(prompt), np.asarray(tok)[:, None]]
    for p in range(P, total - 1):
        logits, cache = decode(jparams, tok, jnp.int32(p), cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok)[:, None])
    return np.concatenate(out, axis=1)


def jax_cross_cache(jcfg, jparams, src_embeds):
    """The cross-attention K/V the JAX ``decode_step`` reads in
    ``cache["cross"]``: the JAX ``encode``'s output times each decoder
    layer's ``cross_attn.wk``/``wv``, ``[L, B, S_src, KV, hd]``."""
    enc = jax_encdec.encode(jparams, jnp.asarray(src_embeds), jcfg)
    ca = jparams["decoder"]["cross_attn"]
    return {n: jnp.einsum("bsd,ldhk->lbshk", enc, ca[w].astype(enc.dtype))
            for n, w in (("k", "wk"), ("v", "wv"))}


def jax_encdec_decode(jcfg, jparams, prompt, gen, cross):
    """Greedy tokens ``[B, P + gen]`` of the JAX encdec ``decode_step`` fed
    the prompt token by token from an empty self-attention cache of ``P +
    gen`` positions (the JAX ``serve_batch``'s loop), with ``cross`` (K/V
    ``[L, B, S_src, KV, hd]``) as the cross-attention cache; returns
    ``(tokens, the last prompt position's logits)``."""
    B, P = prompt.shape
    total = P + gen
    defs = jax_encdec.cache_defs(jcfg, B, total, cross["k"].shape[2])
    cache = {"self": {n: jnp.zeros(d.shape, d.dtype)
                      for n, d in defs["self"].items()},
             "cross": {n: jnp.asarray(cross[n]) for n in ("k", "v")}}
    decode = jax.jit(lambda p, t, pos, c: jax_encdec.decode_step(
        p, t, pos, c, jcfg))
    tok = jnp.asarray(prompt[:, 0])
    out, last = [np.asarray(tok)], None
    for p in range(total - 1):
        logits, cache = decode(jparams, tok, jnp.int32(p), cache)
        if p == P - 1:
            last = np.asarray(logits)
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        tok = jnp.asarray(prompt[:, p + 1]) if p + 1 < P else nxt
        out.append(np.asarray(tok))
    return np.stack(out, axis=1), last


def least_router_margin(cfg, tree, batch, prompt_len, gen, seed):
    """The least top-k router margin over every routing decision of the
    port's f32 ``serve_batch`` on the CPU (prefill and decode steps): how
    far the request is from a near-tie that two implementations could
    break differently."""
    params = lm_params_from_numpy(tree, "cpu")
    with moe.recording() as rec:
        serve_batch(cfg, batch, prompt_len, gen, seed=seed, params=params,
                    device="cpu")
    return min((float(r["margin"].min()) for r in rec), default=math.inf)


def torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
