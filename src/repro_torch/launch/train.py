"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --batch 2 --seq 2048 --accum 2 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT --device cpu

Fault-tolerance demo (injected fault -> checkpoint restart, identical
stream replay): add ``--inject-failure-at 30``.  The flags are the JAX
package's launcher's, plus ``--device`` (cuda by default; it raises
without a card).  As there, a vlm or encdec arch trains its text stack as
a dense LM (no frontend, no encoder): the CLI's batches are token
streams, and modality batches come from the input specs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import make_dataset
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config for CPU")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "memmap"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("vlm", "encdec"):
        cfg = dataclasses.replace(cfg, family="dense", frontend=None,
                                  enc_layers=0)
    ds = make_dataset(args.dataset, vocab=cfg.vocab, batch=args.batch,
                      seq=args.seq, path=args.data_path, seed=args.seed)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        accum=args.accum, compress_grads=args.compress_grads,
        inject_failure_at=args.inject_failure_at, seed=args.seed,
    )
    trainer = Trainer(cfg, opt, tcfg, ds, device=args.device)
    result = trainer.run()
    print(f"final loss: {result['final_loss']:.4f} "
          f"restarts: {result['restarts']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
