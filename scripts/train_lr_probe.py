#!/usr/bin/env python3
"""Which learning rate lets llama3.2-3b's first full-width steps lower the
loss?

    python3 scripts/train_lr_probe.py [--lrs 1e-5:2,3e-5:2,1e-4:8]

``chip_smoke.py``'s ``train`` phase (c) trains llama3.2-3b at full width
for 8 steps (2 x 2,048 synthetic tokens in 2 microbatches, bf16 compute
over f32 master weights, per-layer remat, the attention projections at
their true fan-in) and requires the loss to fall from the first step to
the last.  This script runs the same 8 steps once per ``lr:warmup`` pair
(``AdamWConfig(lr=, warmup_steps=, total_steps=8)``), one after another
in one process, and prints one JSON line each: the losses, grad norms and
step seconds.  Needs one CUDA card with ~57 GB free.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lrs", default="1e-5:2,3e-5:2,1e-4:8",
                    help="comma-separated lr:warmup_steps pairs")
    pairs = [(float(a), int(b)) for a, b in (
        x.split(":") for x in ap.parse_args(argv).lrs.split(","))]
    import torch
    if not torch.cuda.is_available():
        print("train_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    full = smoke.TRAIN_FULL
    cfg = dataclasses.replace(get_config("llama3.2-3b"), remat=True,
                              use_pallas=False)
    for lr, warmup in pairs:
        tr = Trainer(cfg, AdamWConfig(lr=lr, warmup_steps=warmup,
                                      total_steps=full["steps"]),
                     TrainerConfig(steps=full["steps"], accum=full["accum"],
                                   log_every=10**9, seed=0),
                     SyntheticTokens(cfg.vocab, full["batch"], full["seq"],
                                     seed=0),
                     log=lambda *_: None, device="cuda")

        def init_state(tr=tr):
            params, opt, comp = Trainer._init_state(tr)
            smoke.fan_in_attention(params, cfg)
            return params, opt, comp

        tr._init_state = init_state
        res = tr.run()
        print(json.dumps({
            "lr": lr, "warmup": warmup,
            "losses": [h["loss"] for h in res["history"]],
            "grad_norms": [m["grad_norm"] for m in tr.metrics],
            "step_s": [h["dt"] for h in res["history"]],
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del tr, res, init_state
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
