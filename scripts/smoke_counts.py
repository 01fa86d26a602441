#!/usr/bin/env python3
"""Compare the kernel launch counts of two ``chip_smoke.py`` logs, run by
run, for the scheduler phases they share.

    python3 scripts/smoke_counts.py OLD.log NEW.log

Each log is a ``chip_smoke.py`` standard output (one JSON object a line).
The scheduler's launch counts are deterministic: the same runs of the same
engine make the same selections, walks and batched launches on any card.
So a change that leaves a phase's path alone must leave its counts as they
were.  For every phase in ``PHASES`` (the scheduler phases 4-6h) the
script pairs the two logs' lines in order, and compares the count keys
both carry (``launches``, ``walk_launches``, ``batch_launches``,
``batch_selections``, ``walk_batch_launches``, ``walk_batch_walks``,
``redo_walks``, ``cap_reads``) and the digest verdict ``matches_jax``.
Prints one JSON line a phase (lines compared, keys compared, mismatches)
and a last line with the totals; exits 1 on any mismatch or on a phase
whose line counts differ.
"""

from __future__ import annotations

import argparse
import json
import sys

PHASES = ("golden", "archive", "sweep", "ensemble", "alloc", "alloc_sweep",
          "dag", "dag_sweep", "workflow")
KEYS = ("launches", "walk_launches", "batch_launches", "batch_selections",
        "walk_batch_launches", "walk_batch_walks", "redo_walks",
        "cap_reads", "matches_jax")


def phase_lines(path: str, phase: str) -> list:
    out = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith("{"):
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if d.get("phase") == phase:
                out.append(d)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args(argv)
    total = {"lines": 0, "values": 0, "mismatches": 0}
    for phase in PHASES:
        old, new = phase_lines(args.old, phase), phase_lines(args.new, phase)
        bad = []
        values = 0
        if len(old) != len(new):
            bad.append(f"{len(old)} lines against {len(new)}")
        for i, (a, b) in enumerate(zip(old, new)):
            for k in KEYS:
                if k in a and k in b:
                    values += 1
                    if a[k] != b[k]:
                        bad.append(f"line {i} {k}: {a[k]} -> {b[k]}")
        print(json.dumps({"phase": phase, "lines": min(len(old), len(new)),
                          "values": values, "mismatches": bad}))
        total["lines"] += min(len(old), len(new))
        total["values"] += values
        total["mismatches"] += len(bad)
    print(json.dumps({"total": total}))
    return 1 if total["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
