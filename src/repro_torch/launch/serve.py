"""Serving launcher: batched prefill, then a greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --reduced --batch 2 --prompt-len 24 --gen 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --reduced --batch 2 --prompt-len 80 --gen 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4-scout-17b-a16e --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b \
        --reduced --batch 2 --prompt-len 40 --gen 8 --device cpu

(mixtral-8x7b, llama4-scout-17b-a16e and qwen2-vl-72b do not fit one 80 GB
card at full depth in f32.)  A request of ``prompt_len`` positions is split
as the JAX package's input specs split one: for vlm ``int(prompt_len *
frontend_frac)`` patch embeddings before the text tokens, for encdec
``prompt_len // 2`` source frames and the rest target tokens.  The request
path: a batch of prompts -> ``prefill`` (with ``use_pallas`` set, every
attention layer on the flash-attention CUDA kernel, for encdec the
encoder's, the self- and the cross-attention, or, for rwkv, every layer's
time-mix on the linattn_scan CUDA kernel) -> its K/V laid into the decode
cache (for hybrid with the SSM states and conv tails it leaves, for encdec
with the cross-attention's K/V), or for rwkv the recurrent cache it leaves
-> greedy ``decode_step`` with ring-buffer caches for sliding-window
configs, a vlm's positions going on after its patches'.  The JAX package's
``serve_batch`` prefills through decode steps instead.  Both give the same
tokens for the dense, hybrid and rwkv families.  For moe a full-sequence
prefill routes with a capacity and may drop tokens, where a decode step
never does, so the port's tokens are those of the JAX package's
``prefill`` followed by its ``decode_step``.  For vlm and encdec the JAX
``serve_batch`` never draws the patches or the source (its encdec
cross-attention reads a zero cache), so the port's tokens are those of
the JAX package's ``prefill`` with the patches followed by ``decode_step``,
and of ``decode_step`` over the prompt with the cross cache made from
``encode``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.jobs import resolve_device
from repro_torch.models.api import get_model
from repro_torch.sharding.rules import map_defs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prefill_cache(model, prefilled, batch: int, total_len: int, device):
    """The ``cache_defs`` cache for ``total_len`` positions, holding the
    prefill's K/V of its P positions (a vlm's patches and text, an
    encoder-decoder's target prompt): position p in slot p, or, when a
    sliding-window ring is shorter than P, the last C positions in slot
    p % C.  A hybrid model's K/V sit under ``attn``, and its SSM states and
    conv tails are taken as the prefill left them; an encoder-decoder's
    under ``self``, and its ``cross`` K/V as the prefill left them."""
    defs = model.cache_defs_fn(batch, total_len)
    key = "attn" if "attn" in defs else "self" if "self" in defs else None
    cache = map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                           device=device),
                     defs[key] if key else defs)
    kv = prefilled[key] if key else prefilled
    C, P = cache["k"].shape[2], kv["k"].shape[2]
    pos = torch.arange(max(P - C, 0), P, device=device)
    for name, t in cache.items():
        t[:, :, pos % C] = kv[name][:, :, pos]
    if key is None:
        return cache
    return {**{n: t for n, t in prefilled.items() if n != key}, key: cache}


def request_inputs(cfg, batch: int, prompt_len: int, seed: int):
    """A batch of requests of ``prompt_len`` positions as numpy arrays,
    drawn from ``np.random.default_rng(seed)``: the prompt tokens, then
    (vlm) ``int(prompt_len * frontend_frac)`` patch embeddings before
    ``prompt_len - that`` text tokens, or (encdec) ``prompt_len // 2``
    source frames and ``prompt_len - prompt_len // 2`` target tokens, as
    the JAX package's input specs split a sequence.  Returns ``{"tokens"
    [B, T] int32, and "patches" or "src_embeds" [B, n, D] float32}``."""
    rng = np.random.default_rng(seed)
    front = {"vlm": int(prompt_len * cfg.frontend_frac),
             "encdec": prompt_len // 2}.get(cfg.family, 0)
    out = {"tokens": rng.integers(1, cfg.vocab - 1, (
        batch, prompt_len - front)).astype(np.int32)}
    if front:
        name = "patches" if cfg.family == "vlm" else "src_embeds"
        out[name] = rng.standard_normal((batch, front, cfg.d_model),
                                        dtype=np.float32)
    return out


@torch.inference_mode()
def serve_batch(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
                params=None, device=None, inputs=None):
    """Serve ``batch`` random requests of ``prompt_len`` positions
    (:func:`request_inputs`) and generate ``gen`` tokens each, greedily.
    Returns ``(seqs [B, T + gen] int32, stats)``, where T is the prompt's
    token count (``prompt_len`` but for vlm and encdec).

    Prompts come from ``np.random.default_rng(seed)`` as in the JAX
    package, the patches or source frames after them.  ``params`` (an
    ``LM``) defaults to random weights drawn on the device from a generator
    seeded with ``seed``.  ``inputs`` (numpy arrays as
    :func:`request_inputs` returns them) replays a recorded request instead
    of drawing one.  Runs on ``cuda`` unless ``device="cpu"`` is passed,
    and raises without a card.
    """
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    device = resolve_device(device)
    model = get_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(seed))
    if inputs is None:
        inputs = request_inputs(cfg, batch, prompt_len, seed)
    inputs = {n: torch.from_numpy(np.asarray(a)).to(device)
              for n, a in inputs.items()}
    prompts = inputs["tokens"]
    # the positions the model has run when decoding starts: a vlm's
    # patches come first; an encoder-decoder's source is not among them
    start = prompts.shape[1] + (inputs["patches"].shape[1]
                                if "patches" in inputs else 0)
    total_len = start + gen

    _sync(device)
    t0 = time.perf_counter()
    logits, prefilled = model.prefill(params, inputs)
    if cfg.family == "rwkv":   # a recurrent cache has no sequence axis
        cache = prefilled
    else:
        cache = _prefill_cache(model, prefilled, batch, total_len, device)
    del prefilled
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    out = [prompts, tok[:, None]]
    for pos in range(start, total_len - 1):
        logits, cache = model.decode_step(params, tok, pos, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok[:, None])
    seqs = torch.cat(out, dim=1)
    _sync(device)
    t2 = time.perf_counter()
    toks = batch * (prompt_len + gen - 1)   # positions run through the model
    decoded = batch * (gen - 1)         # tokens from decode steps
    return seqs, {"tokens": toks, "seconds": t2 - t0,
                  "tok_per_s": toks / (t2 - t0),
                  "prefill_s": t1 - t0, "decode_s": t2 - t1,
                  "decode_tok_per_s": decoded / (t2 - t1) if decoded else 0.0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, use_pallas=True)
    seqs, stats = serve_batch(cfg, args.batch, args.prompt_len, args.gen,
                              seed=args.seed, device=args.device)
    print(f"generated {tuple(seqs.shape)} tokens: prefill "
          f"{stats['prefill_s']:.3f}s, decode {stats['decode_tok_per_s']:.1f} "
          f"tok/s, {stats['tok_per_s']:.1f} tok/s overall "
          f"({stats['seconds']:.2f}s)")


if __name__ == "__main__":
    main()
