#!/usr/bin/env python3
"""Where do two f32 paths of a full-width MoE model part in their routing?

    python3 scripts/moe_route_probe.py [--arch mixtral-8x7b] [--len 4608]

``chip_smoke.py``'s phase ``moe_serve`` (a) compares the whole model's
f32 last-position logits on the kernel path (the flash kernel) with the
plain path (the blockwise attention), each layer's routing recorded.  Top-k
routing is discontinuous, so a rounding difference can pick another
expert.  This script builds the same model (``chip_smoke.moe_full_width``:
the layers MOE_SERVE keeps, seed 0, the attention at its true fan-in) and
the same prompt, and prints one JSON line a layer for three comparisons:

- ``chained``: the two paths run whole, as the phase runs them: the
  tokens whose experts differ, their router margins on each path, and how
  far apart the MoE layer's inputs (the ln2 outputs) and outputs already
  are (largest difference over the largest entry);
- ``control``: the plain path against itself with other attention tiles
  (``block_q = block_k = 256``): the same numbers for a change of
  summation order alone;
- ``forced``: each layer run on both paths from the plain path's input to
  that layer, so no difference is carried from the layers before.

Needs one CUDA card with ~62 GB free.
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
    return float((a - b).abs().max() / b.abs().max())


def _diff(rec_a, rec_b, layer: int) -> dict:
    a, b = rec_a[layer], rec_b[layer]
    picked = (a["gate_idx"] != b["gate_idx"]).any(-1)
    out = {"tokens_differing": int(picked.sum()),
           "kept_differing": int((a["kept"] != b["kept"]).any(-1).sum()),
           "least_margin": min(float(a["margin"].min()),
                               float(b["margin"].min()))}
    if bool(picked.any()):
        out["margins_a"] = sorted(float(m) for m in a["margin"][picked])[:8]
        out["margins_b"] = sorted(float(m) for m in b["margin"][picked])[:8]
    if "x" in a:
        out["input_rel_diff"] = _rel(a["x"], b["x"])
        out["output_rel_diff"] = _rel(a["y"], b["y"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--len", type=int, default=None,
                    help="prompt tokens (default: chip_smoke's MOE_CHECK_LEN)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("moe_route_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.models import lm, moe
    from repro_torch.models.layers import embed_tokens

    n = args.len or smoke.MOE_CHECK_LEN
    base, _, params = smoke.moe_full_width(torch, args.arch)
    kernel = dataclasses.replace(base, dtype="float32", use_pallas=True)
    plain = dataclasses.replace(kernel, use_pallas=False)
    control = dataclasses.replace(plain, block_q=256, block_k=256)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, base.vocab - 1, (1, n))).to("cuda")

    real = moe.apply_moe

    def keeping(p, x, cfg):
        y, aux = real(p, x, cfg)
        moe._RECORD[-1].update(x=x.detach().clone(), y=y.detach().clone())
        return y, aux

    moe.apply_moe = keeping
    recs = {}
    try:
        for name, cfg in (("kernel", kernel), ("plain", plain),
                          ("control", control)):
            with moe.recording() as rec:
                lm.prefill(params, {"tokens": toks}, cfg)
            recs[name] = rec
    finally:
        moe.apply_moe = real
    for layer in range(base.n_layers):
        print(json.dumps({"arch": args.arch, "layer": layer, "tokens": n,
                          "chained": _diff(recs["kernel"], recs["plain"],
                                           layer),
                          "control": _diff(recs["control"], recs["plain"],
                                           layer)}), flush=True)
    del recs

    # each layer from the plain path's input to it
    tree = params.tree()
    with torch.no_grad():
        h = embed_tokens(tree["embed"], toks, plain)
        positions = torch.arange(n, device="cuda")[None]
        for layer in range(base.n_layers):
            lp = lm._layer(tree["blocks"], layer)
            with moe.recording() as rk:
                hk, _, _ = lm._block(kernel, lp, h, positions)
            with moe.recording() as rp:
                hp, _, _ = lm._block(plain, lp, h, positions)
            print(json.dumps({"arch": args.arch, "layer": layer,
                              "forced": _diff(rk, rp, 0),
                              "block_out_rel_diff": _rel(hk, hp)}),
                  flush=True)
            h = hp
    return 0


if __name__ == "__main__":
    sys.exit(main())
