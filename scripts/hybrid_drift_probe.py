#!/usr/bin/env python3
"""How far apart do two f32 evaluations of full-depth zamba2-2.7b drift?

    python3 scripts/hybrid_drift_probe.py [--len 512]

``chip_smoke.py``'s phase ``hybrid_serve`` (a) compares the f32 prefill
on the kernel path (the flash kernel in the shared block) with the plain
path (the blockwise attention).  This script builds the same model
(``chip_smoke.hybrid_full_width``: seed 0, the Mamba2 leaves drawn live,
the shared block's projections at their true fan-in) and the same prompt,
and prints one JSON line a group of 6 Mamba2 layers and the shared block:
how far the hidden state after the group is, over its largest entry, on

- ``kernel``: the kernel path, f32;
- ``control``: the plain path with other attention tiles (``block_q =
  block_k = 256``), f32: a change of summation order alone;
- ``f64``: the plain path in float64 (the reference both f32 paths are
  held to)

each against the plain path in f32, and the kernel path and the plain f32
path against f64; then ``forced``: the group run on both paths from the
plain path's input to it.  The last line compares the last-position
logits the same ways.  Needs one CUDA card with ~30 GB free.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--len", type=int, default=None,
                    help="prompt tokens (default: chip_smoke's CHECK_LEN)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hybrid_drift_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    n = args.len or smoke.CHECK_LEN
    base, _, params = smoke.hybrid_full_width(torch)
    kernel = dataclasses.replace(base, dtype="float32", use_pallas=True)
    plain = dataclasses.replace(kernel, use_pallas=False)
    control = dataclasses.replace(plain, block_q=256, block_k=256)
    f64 = dataclasses.replace(plain, dtype="float64")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, base.vocab - 1, (1, n))).to("cuda")
    params64 = lm.LM(tree_map(lambda t: t.double(), params.tree()))

    real = lm._block
    outs = {}

    def keeping(cfg, p, h, positions, **kw):
        out = real(cfg, p, h, positions, **kw)
        outs[current].append(out[0].detach().clone())
        return out

    lm._block = keeping
    logits = {}
    try:
        for current, cfg, prm in (("plain", plain, params),
                                  ("kernel", kernel, params),
                                  ("control", control, params),
                                  ("f64", f64, params64)):
            outs[current] = []
            logits[current], _ = lm.prefill(prm, {"tokens": toks}, cfg)
    finally:
        lm._block = real
    for g, want in enumerate(outs["plain"]):
        print(json.dumps({
            "group": g, "tokens": n,
            "kernel_vs_plain": _rel(outs["kernel"][g], want),
            "control_vs_plain": _rel(outs["control"][g], want),
            "f64_vs_plain": _rel(outs["f64"][g], want),
            "kernel_vs_f64": _rel(outs["kernel"][g], outs["f64"][g])}),
            flush=True)
    print(json.dumps({"logits": True, "tokens": n, **{
        f"{a}_vs_{b}_max_abs": float((logits[a].double()
                                       - logits[b].double()).abs().max())
        for a, b in (("kernel", "plain"), ("control", "plain"),
                     ("kernel", "f64"), ("plain", "f64"))},
        "max_abs_logit": float(logits["f64"].abs().max())}), flush=True)
    del outs, logits, params64

    # each group from the plain path's input to it
    tree = params.tree()
    from repro_torch.models import ssm
    from repro_torch.models.layers import embed_tokens
    with torch.no_grad():
        h = embed_tokens(tree["embed"], toks, plain)
        positions = torch.arange(n, device="cuda")[None]
        for g in range(base.n_layers // base.attn_every):
            gp = lm._layer(tree["mamba"], g)
            for j in range(base.attn_every):
                h = h + ssm.apply_ssm(lm._layer(gp, j), h, plain)[0]
            hk, _, _ = real(kernel, tree["shared_attn"], h, positions)
            hp, _, _ = real(plain, tree["shared_attn"], h, positions)
            print(json.dumps({"group": g, "forced_kernel_vs_plain":
                              _rel(hk, hp)}), flush=True)
            h = hp
    return 0


if __name__ == "__main__":
    sys.exit(main())
