#!/usr/bin/env python3
"""Loop the sm90 linattn kernel's mixed-decay card cases over generator seeds.

    python3 scripts/linattn_seed_loop.py [--seeds 256] [--seconds 600] \
        [--out PATH]

Needs one Hopper card and nvcc.  ``tests/test_torch_kernels_cuda.py``'s
mixed cases of ``LINATTN_SM90_CASES`` draw their decays' factor from a CUDA
generator; this script draws it with each seed in ``0 .. seeds-1`` in turn
(the test's ``_sm90_case_inputs`` with ``"mixed:<seed>"``) and, for f32 and
bf16 logw, measures:

- the kernel against ``ref.py``'s statement of its arithmetic
  (``sm90_statement_errs``: y beyond one bf16 ulp over y's largest entry,
  y's RMS error, the state's largest error), against the statement test's
  tolerances (its first run, which settled them, held them at 1e-3, 1e-3
  and 1e-5);
- the kernel, the statement and the f32 token scan (``linattn_reference``)
  each against a float64 token scan of the same inputs (the test module's
  ``scan64``, ``errs64``): y's largest error over y's largest entry, y's
  RMS error over its RMS, and the state's largest error over its largest
  entry;
- whether two calls of the kernel on the same inputs give equal tensors.

Writes one JSON line a (case, seed, logw dtype) to ``--out`` (default
``build/linattn_seed_loop.jsonl``) and prints a summary line per case
(the seeds that failed a statement tolerance, the worst readings, whether
every pair of calls was equal), then the card's name and power limit.
Stops starting new seeds after ``--seconds``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=256)
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "linattn_seed_loop.jsonl")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("linattn_seed_loop: no CUDA device", file=sys.stderr)
        return 1
    import test_torch_kernels_cuda as cases
    from repro_torch.kernels.linattn_scan import ops as lops
    from repro_torch.kernels.linattn_scan.ref import (
        linattn_reference, linattn_sm90_reference, sm90_statement_errs)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as log:
        t_end = time.time() + args.seconds
        y_tol, rms_tol, s_tol = (cases.STATEMENT_Y_TOL,
                                 cases.STATEMENT_Y_RMS_TOL,
                                 cases.STATEMENT_STATE_TOL)
        mixed = [c for c in cases.LINATTN_SM90_CASES if c[4] == "mixed"]
        for B, H, S, K, _ in mixed:
            worst = {}
            failed, unequal, n = [], 0, 0
            for seed in range(args.seeds):
                if time.time() > t_end:
                    break
                r, k, v, lw, u = cases._sm90_case_inputs(B, H, S, K,
                                                         f"mixed:{seed}")
                for logw_t in (lw, lw.to(torch.bfloat16)):
                    args_t = (r, k, v, logw_t, u)
                    got = lops.linattn(*args_t, return_state=True)
                    again = lops.linattn(*args_t, return_state=True)
                    equal = bool(torch.equal(got[0], again[0])
                                 and torch.equal(got[1], again[1]))
                    cpu = [x.cpu() for x in args_t]
                    stmt = linattn_sm90_reference(*cpu)
                    ey, rms, es = sm90_statement_errs(got, stmt)
                    f64 = cases.scan64(*cpu)
                    row = {"case": [B, H, S, K], "seed": seed,
                           "logw": str(logw_t.dtype).split(".")[-1],
                           "statement": {"y_max": ey, "y_rms": rms,
                                         "state_max": es},
                           "passes": (ey < y_tol and rms < rms_tol
                                      and es < s_tol),
                           "repeat_equal": equal,
                           "kernel_vs_f64": cases.errs64(got, f64),
                           "statement_vs_f64": cases.errs64(stmt, f64),
                           "scan_f32_vs_f64": cases.errs64(
                               linattn_reference(*cpu), f64)}
                    log.write(json.dumps(row) + "\n")
                    n += 1
                    unequal += not equal
                    if not row["passes"]:
                        failed.append([seed, row["logw"], ey, rms, es])
                    for who in ("kernel_vs_f64", "statement_vs_f64",
                                "scan_f32_vs_f64"):
                        for key, val in row[who].items():
                            name = f"{who}.{key}"
                            worst[name] = max(worst.get(name, 0.0), val)
                    for key, val in row["statement"].items():
                        worst[f"statement.{key}"] = max(
                            worst.get(f"statement.{key}", 0.0), val)
            print(json.dumps({"case": [B, H, S, K], "calls": n,
                              "seeds": n // 2, "failed": failed,
                              "repeat_unequal": unequal, "worst": worst}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
