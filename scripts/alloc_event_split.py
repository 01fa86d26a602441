#!/usr/bin/env python3
"""Time the machine-mode event step's block log against one reduction an
event, in paired runs on one card.

    python3 scripts/alloc_event_split.py [--rounds 2] [--n-jobs 10000]

Needs one Hopper card and nvcc.  Writes a variant of the port's source
into ``build/alloc_event_split/`` (gitignored; a timing probe, never part
of the port) and runs the port and the variant in turns (A B B A, each
round), one process a tree, each doing the same 10,000-job SDSC-SP2-like
backfill runs on ``dragonfly(16, 8)`` under ``simple`` (the batched pass)
and ``contiguous`` (the per-start loop), contention off, with the wall
clock around ``run`` and ``to_np()``.  Each run's ``n_events`` and
``makespan`` are held to ``tests/data/torch_alloc_golden.json`` when
``--n-jobs`` is the file's job count (5,000).  Prints
one JSON line per (round, tree, run), then the card's name and power
limit.

Variants:
  block      unchanged: each event copies the map into a ring of snapshots
             and one reduction a full ring writes ``ev_lfb``; completions
             free their nodes after the event's read, and only when some
             job completed (under ``simple``); ``group_span`` gathers each
             group's nodes through ``Machine.group_table``
  per_event  one largest-free-run reduction an event into ``ev_lfb``,
             completions freed before the read at every event, and
             ``group_span`` from a cumulative count (the first design)
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "alloc_event_split"
GOLDEN = ROOT / "tests" / "data" / "torch_alloc_golden.json"
RUNS = ("simple", "contiguous")

PER_EVENT = {
    "core/engine.py": [
        ("""    if state.lfb is not None:
        _release_nodes(state.node_owner, completed)
        reads.append(_alloc.largest_free_run(state.node_owner).long())
    clock, freed, n_completed, *lfb = torch.stack(reads).tolist()
    if ctx is not None and state.lfb is None and n_completed:
        _release_nodes(state.node_owner, completed)
""", """    if ctx is not None:
        _release_nodes(state.node_owner, completed)
        if state.lfb is not None:
            reads.append(_alloc.largest_free_run(state.node_owner).long())
    clock, freed, n_completed, *lfb = torch.stack(reads).tolist()
"""),
        ("        log.add(state.node_owner, slot)\n",
         "        state.ev_lfb[slot] = _alloc.largest_free_run("
         "state.node_owner)\n")],
    "alloc/strategies.py": [
        ("""    padded = torch.nn.functional.pad(mask, (0, 1))
    touched = torch.any(padded[..., machine.group_table], dim=-1)
    return torch.sum(touched, dim=-1, dtype=torch.int32)""",
         """    csum = torch.cumsum(mask, -1, dtype=torch.int32)
    within = csum - _group_base(machine, csum)
    return torch.sum(mask & (within == 1), dim=-1, dtype=torch.int32)""")],
}
VARIANTS = {"block": {}, "per_event": PER_EVENT}


def write_variant(name: str) -> pathlib.Path:
    """The variant's ``src`` directory (the port's own for ``block``)."""
    if not VARIANTS[name]:
        return ROOT / "src"
    dst = OUT / name / "src"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, edits in VARIANTS[name].items():
        path = dst / "repro_torch" / rel
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {rel} does not hold one copy of "
                                 f"{old[:60]!r}")
            text = text.replace(old, new)
        path.write_text(text)
    return dst


def child(n_jobs: int, device: str) -> None:
    """The runs of one tree (on ``sys.path`` already), one JSON line
    each."""
    import torch
    import repro_torch as rt

    golden = {e["alloc"]: e for e in json.loads(GOLDEN.read_text())["runs"]
              if (e["kind"], e["policy"], e["contention"])
              == ("sdsc_sp2", "backfill", None)}
    for alloc in RUNS:
        scn = rt.Scenario(
            trace=rt.SyntheticTrace(n_jobs=n_jobs, seed=1, kind="sdsc_sp2"),
            topology=rt.Topology.dragonfly(16, 8), policy="backfill",
            alloc=alloc)
        t = time.time()
        out = rt.run(scn, device=device).to_np()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.time() - t
        if n_jobs == golden[alloc]["n_jobs"]:
            for k in ("n_events", "makespan"):
                if out[k] != golden[alloc][k]:
                    raise SystemExit(f"{alloc}: {k} {out[k]} != golden "
                                     f"{golden[alloc][k]}")
        print(json.dumps({"alloc": alloc, "n_events": out["n_events"],
                          "seconds": wall,
                          "events_per_s": out["n_events"] / wall}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--n-jobs", type=int, default=10_000)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script with the plain path")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, args.child)
        child(args.n_jobs, args.device)
        return 0
    trees = {name: write_variant(name) for name in VARIANTS}
    order = ["per_event", "block", "block", "per_event"]
    for rnd in range(args.rounds):
        for name in order:
            got = subprocess.run(
                [sys.executable, __file__, "--child", str(trees[name]),
                 "--n-jobs", str(args.n_jobs), "--device", args.device],
                check=True, capture_output=True, text=True)
            for line in got.stdout.splitlines():
                print(json.dumps({"round": rnd, "variant": name,
                                  **json.loads(line)}), flush=True)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
