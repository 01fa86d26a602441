"""Encoder-decoder transformer (the seamless-m4t backbone): parameters,
encoder, full forward, loss, prefill, decode.

Counterpart of ``repro.models.encdec``.  The audio frontend is a stub, as
there: a batch brings precomputed frame embeddings ``src_embeds [B, S_src,
D]``, projected by ``frontend_proj``; the encoder is a bidirectional
transformer over them, the decoder a causal transformer with
cross-attention to the encoder's output.  RoPE rotates the encoder's and
the decoder's self-attention, never the cross-attention.

    loss_fn(params, batch, cfg)                  -> (loss, {"ce", "aux"})
    forward(params, batch, cfg)                  -> logits [B, S_tgt, V]
    prefill(params, batch, cfg)                  -> (last_logits, cache)
    decode_step(params, tokens, pos, cache, cfg) -> (logits, cache)

With ``cfg.use_pallas`` set, all three attentions of a layer go through
``attention.attend`` and so through the flash-attention CUDA kernel: the
encoder's (bidirectional), the decoder's self-attention (causal) and its
cross-attention (non-causal, ``S_tgt != S_src`` in general).  The JAX
package runs the blockwise path everywhere in this family; routing it to
the kernel is the port's serving extension.  ``loss_fn`` always takes the
blockwise path: the kernel has no backward pass.

``prefill`` returns the decode cache, which the JAX package has no producer
for: ``self`` holds the prompt's K/V ``[L, B, S_tgt, KV, hd]`` and
``cross`` each layer's ``enc_out @ cross_attn.wk/wv`` ``[L, B, S_src, KV,
hd]``, as ``decode_step`` reads them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp, apply_norm, apply_rope, checkpointed, chunked_lm_loss,
    compute_dtype, embed_defs, embed_tokens, logits_from_hidden, mlp_defs,
    mm, norm_defs,
)
from repro_torch.models.lm import LM, _layer, _proj, _stack
from repro_torch.sharding.rules import (
    TRAIN_RULES, ParamDef, ShardingRules, constrain, like,
)

Tree = dict


def param_defs(cfg: ModelConfig) -> Tree:
    enc_l, dec_l = (cfg.enc_layers,), (cfg.n_layers,)
    return {
        "embed": embed_defs(cfg),
        "frontend_proj": ParamDef((cfg.d_model, cfg.d_model),
                                  ("embed_fsdp", None)),
        "encoder": {
            "ln1": norm_defs(cfg, enc_l),
            "attn": attn.attn_defs(cfg, enc_l),
            "ln2": norm_defs(cfg, enc_l),
            "mlp": mlp_defs(cfg, enc_l),
        },
        "enc_norm": norm_defs(cfg),
        "decoder": {
            "ln1": norm_defs(cfg, dec_l),
            "self_attn": attn.attn_defs(cfg, dec_l),
            "ln_x": norm_defs(cfg, dec_l),
            "cross_attn": attn.attn_defs(cfg, dec_l),
            "ln2": norm_defs(cfg, dec_l),
            "mlp": mlp_defs(cfg, dec_l),
        },
        "final_norm": norm_defs(cfg),
    }


def cache_defs(cfg: ModelConfig, batch: int, tgt_len: int,
               src_len: int) -> Tree:
    """The decoder's self-attention K/V ``[L, B, tgt_len, KV, hd]`` and the
    cross-attention K/V ``[L, B, src_len, KV, hd]``, in the compute
    dtype."""
    dt = compute_dtype(cfg)

    def kv(length):
        shape = (cfg.n_layers, batch, length, cfg.kv_heads_c, cfg.head_dim)
        axes = ("layers", "cache_batch", "cache_seq", "kv", None)
        return {k: ParamDef(shape, axes, init="zeros", dtype=dt)
                for k in ("k", "v")}

    return {"self": kv(tgt_len), "cross": kv(src_len)}


def _proj_qkv(cfg, p, x, positions=None):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if positions is not None:
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    return q, k, v


def _out(p, o):
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    return mm(o.flatten(2), p["wo"].reshape(-1, p["wo"].shape[-1]).to(o.dtype))


def _remat(cfg, fn):
    """``fn`` (one layer) recomputed in the backward pass under
    ``cfg.remat``, as the reference's ``nothing_saveable`` scan body."""
    return (lambda *a: checkpointed(fn, *a)) if cfg.remat else fn


def _positions(h: torch.Tensor) -> torch.Tensor:
    """``[1, S]`` positions of ``h``'s sequence (replicated on its mesh)."""
    return like(torch.arange(h.shape[1], dtype=torch.int32,
                             device=h.device)[None], h)


def _act(h, rules, mesh):
    return constrain(h, ("act_batch", "act_seq", "act_embed"), rules, mesh)


def _encoder_layer(cfg, lp, h, positions, rules, mesh):
    """One encoder layer: bidirectional self-attention, then the MLP."""
    a = apply_norm(lp["ln1"], h, cfg)
    q, k, v = _proj_qkv(cfg, lp["attn"], a, positions)
    h = h + _out(lp["attn"], attn.attend(cfg, q, k, v, causal=False))
    m = apply_norm(lp["ln2"], h, cfg)
    return _act(h + apply_mlp(lp["mlp"], m, cfg), rules, mesh)


def _frontend(params: Tree, src_embeds: torch.Tensor, cfg: ModelConfig,
              rules, mesh):
    """The projected source frames, the encoder's input, and their
    positions."""
    dt = compute_dtype(cfg)
    src = like(src_embeds, params["frontend_proj"])
    h = _act(mm(src.to(dt), params["frontend_proj"].to(dt)), rules, mesh)
    return h, _positions(h)


def encode(params: Tree, src_embeds: torch.Tensor, cfg: ModelConfig, *,
           rules: ShardingRules = TRAIN_RULES, mesh=None):
    """The encoder's output ``[B, S_src, D]`` after ``enc_norm``."""
    params = params.tree() if isinstance(params, LM) else params
    h, positions = _frontend(params, src_embeds, cfg, rules, mesh)
    body = _remat(cfg, lambda hh, lp: _encoder_layer(cfg, lp, hh, positions,
                                                     rules, mesh))
    for i in range(cfg.enc_layers):
        h = body(h, _layer(params["encoder"], i))
    return apply_norm(params["enc_norm"], h, cfg)


def _decoder_block(cfg, lp, h, enc_out, positions, rules, mesh):
    """One decoder layer over the whole target; returns (h, its self K/V,
    its cross K/V)."""
    a = apply_norm(lp["ln1"], h, cfg)
    q, k, v = _proj_qkv(cfg, lp["self_attn"], a, positions)
    h = h + _out(lp["self_attn"], attn.attend(cfg, q, k, v, causal=True))
    x = apply_norm(lp["ln_x"], h, cfg)
    pc = lp["cross_attn"]
    xq, xk, xv = _proj(x, pc["wq"]), _proj(enc_out, pc["wk"]), _proj(
        enc_out, pc["wv"])
    h = h + _out(pc, attn.attend(cfg, xq, xk, xv, causal=False))
    m = apply_norm(lp["ln2"], h, cfg)
    h = _act(h + apply_mlp(lp["mlp"], m, cfg), rules, mesh)
    return h, {"k": k, "v": v}, {"k": xk, "v": xv}


def _tokens(params: Tree, tokens: torch.Tensor, cfg: ModelConfig):
    """The target's embeddings; under a mesh the ids join it replicated
    (as ``lm._embed_inputs``)."""
    return embed_tokens(params["embed"], like(tokens, params["embed"]["tok"]),
                        cfg)


def _decode(params: Tree, batch, cfg: ModelConfig, collect_cache: bool,
            rules, mesh):
    """Encoder, then the decoder's layers and final norm: (h, cache or
    None)."""
    enc_out = encode(params, batch["src_embeds"], cfg, rules=rules,
                     mesh=mesh)
    h = _act(_tokens(params, batch["tokens"], cfg), rules, mesh)
    positions = _positions(h)
    block = _remat(cfg, lambda hh, lp: _decoder_block(
        cfg, lp, hh, enc_out, positions, rules, mesh))
    selfs, crosses = [], []
    for i in range(cfg.n_layers):
        h, kv, xkv = block(h, _layer(params["decoder"], i))
        if collect_cache:
            selfs.append(kv)
            crosses.append(xkv)
    h = apply_norm(params["final_norm"], h, cfg)
    if not collect_cache:
        return h, None
    return h, {"self": _stack(selfs), "cross": _stack(crosses)}


def forward(params, batch, cfg: ModelConfig, *,
            rules: ShardingRules = TRAIN_RULES, mesh=None) -> torch.Tensor:
    """batch: ``{"src_embeds": [B, S_src, D], "tokens": [B, S_tgt]}``;
    returns the logits ``[B, S_tgt, V]``."""
    params = params.tree() if isinstance(params, LM) else params
    h, _ = _decode(params, batch, cfg, False, rules, mesh)
    logits = logits_from_hidden(params["embed"], h, cfg)
    return constrain(logits, ("batch", None, "vocab"), rules, mesh)


def loss_fn(params, batch, cfg: ModelConfig, *,
            rules: ShardingRules = TRAIN_RULES, mesh=None):
    """Mean next-token CE of ``batch["labels"]`` over the target, on the
    blockwise attention whatever ``cfg.use_pallas`` says; returns ``(loss,
    {"ce": loss, "aux": 0})``.  ``params`` is an ``LM`` or its tree."""
    params = params.tree() if isinstance(params, LM) else params
    cfg = dataclasses.replace(cfg, use_pallas=False)
    h, _ = _decode(params, batch, cfg, False, rules, mesh)
    labels = constrain(batch["labels"], ("batch", None), rules, mesh)
    loss = chunked_lm_loss(params["embed"], h, labels, cfg, rules, mesh)
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=h.device)}


@torch.no_grad()
def prefill(params: LM, batch, cfg: ModelConfig, *,
            rules: ShardingRules = TRAIN_RULES, mesh=None):
    """Encode the source and run the target prompt: the last position's
    logits ``[B, V]`` and the decode cache (``self``: the prompt's K/V;
    ``cross``: the cross-attention's K/V of the encoder's output)."""
    params = params.tree() if isinstance(params, LM) else params
    h, cache = _decode(params, batch, cfg, True, rules, mesh)
    logits = logits_from_hidden(params["embed"], h[:, -1:], cfg)[:, 0]
    return constrain(logits, ("batch", "vocab"), rules, mesh), cache


@torch.no_grad()
def decode_step(params: LM, tokens: torch.Tensor, pos: int, cache: Tree,
                cfg: ModelConfig, *, rules: ShardingRules = TRAIN_RULES,
                mesh=None):
    """One decoder token at position ``pos``; ``cache``: the
    ``cache_defs`` tree, its ``self`` K/V written in place at ``pos``, its
    ``cross`` K/V read whole.  Returns ``(logits [B, V], cache)``."""
    params = params.tree() if isinstance(params, LM) else params
    h = _tokens(params, tokens[:, None], cfg)
    positions = like(torch.full((1, 1), pos, dtype=torch.int32,
                                device=h.device), h)
    sc, xc = cache["self"], cache["cross"]
    for i in range(cfg.n_layers):
        lp = _layer(params["decoder"], i)
        a = apply_norm(lp["ln1"], h, cfg)
        q, k, v = _proj_qkv(cfg, lp["self_attn"], a, positions)
        sc["k"][i, :, pos] = k[:, 0]
        sc["v"][i, :, pos] = v[:, 0]
        o = attn.decode_attention(q, sc["k"][i], sc["v"][i], pos=pos)
        h = h + _out(lp["self_attn"], o)
        x = apply_norm(lp["ln_x"], h, cfg)
        q = _proj(x, lp["cross_attn"]["wq"])
        xk, xv = xc["k"][i], xc["v"][i]
        o = attn.decode_attention(q, xk, xv, pos=xk.shape[1] - 1)
        h = h + _out(lp["cross_attn"], o)
        m = apply_norm(lp["ln2"], h, cfg)
        h = h + apply_mlp(lp["mlp"], m, cfg)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = logits_from_hidden(params["embed"], h, cfg)[:, 0]
    return constrain(logits, ("act_batch", "vocab"), rules, mesh), cache
