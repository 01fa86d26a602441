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

(mixtral-8x7b and llama4-scout-17b-a16e do not fit one 80 GB card at full
depth in f32.)  The request path: a batch of prompts -> ``prefill`` (with
``use_pallas`` set, every attention layer on the flash-attention CUDA
kernel, or, for rwkv, every layer's time-mix on the linattn_scan CUDA
kernel) -> its K/V laid into the decode cache (for hybrid with the SSM
states and conv tails it leaves), or for rwkv the recurrent cache it
leaves -> greedy ``decode_step`` with ring-buffer caches for
sliding-window configs.  The JAX package's ``serve_batch`` prefills
through decode steps instead.  Both give the same tokens, but for moe:
there a full-sequence prefill routes with a capacity and may drop tokens,
where a decode step never does, so the port's tokens are those of the JAX
package's ``prefill`` followed by its ``decode_step``.
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


def _prefill_cache(model, prefilled, batch: int, prompt_len: int,
                   total_len: int, device):
    """The ``cache_defs`` cache for ``total_len`` positions, holding the
    prompt's K/V: position p in slot p, or, when a sliding-window ring is
    shorter than the prompt, the last C positions in slot p % C.  A hybrid
    model's K/V sit under ``attn``, and its SSM states and conv tails are
    taken as the prefill left them."""
    defs = model.cache_defs_fn(batch, total_len)
    hybrid = "attn" in defs
    cache = map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                           device=device),
                     defs["attn"] if hybrid else defs)
    C = cache["k"].shape[2]
    pos = torch.arange(max(prompt_len - C, 0), prompt_len, device=device)
    kv = prefilled["attn"] if hybrid else prefilled
    for name, t in cache.items():
        t[:, :, pos % C] = kv[name][:, :, pos]
    if hybrid:
        return {"attn": cache, "ssm_state": prefilled["ssm_state"],
                "conv": prefilled["conv"]}
    return cache


@torch.inference_mode()
def serve_batch(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
                params=None, device=None):
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and generate
    ``gen`` tokens each, greedily.  Returns ``(seqs [B, prompt_len + gen]
    int32, stats)``.

    Prompts come from ``np.random.default_rng(seed)`` as in the JAX
    package.  ``params`` (an ``LM``) defaults to random weights drawn on
    the device from a generator seeded with ``seed``.  Runs on ``cuda``
    unless ``device="cpu"`` is passed, and raises without a card.
    """
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    device = resolve_device(device)
    model = get_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab - 1, (batch, prompt_len)).astype(np.int32)
    ).to(device)
    total_len = prompt_len + gen

    _sync(device)
    t0 = time.perf_counter()
    logits, prefilled = model.prefill(params, {"tokens": prompts})
    if cfg.family == "rwkv":   # a recurrent cache has no sequence axis
        cache = prefilled
    else:
        cache = _prefill_cache(model, prefilled, batch, prompt_len,
                               total_len, device)
    del prefilled
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    out = [prompts, tok[:, None]]
    for pos in range(prompt_len, total_len - 1):
        logits, cache = model.decode_step(params, tok, pos, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok[:, None])
    seqs = torch.cat(out, dim=1)
    _sync(device)
    t2 = time.perf_counter()
    toks = batch * (total_len - 1)     # positions run through the model
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
