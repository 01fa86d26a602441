#!/usr/bin/env python3
"""Time the batched queue_select entries against the solo ones, and two ways
of handing a launch its requests.

    python3 scripts/queue_select_batch_split.py

Needs one Hopper card and nvcc.  Writes variants of
``src/repro_torch/kernels/queue_select/csrc/queue_select.cu`` into
``build/queue_select_split/`` (gitignored; timing probes, never part of the
port), builds each with the port's nvcc flags, and times, on random stacked
tables of J = 10,000 rows a member (phase 3b's tables of ``chip_smoke.py``,
1% of rows running), one batched ``backfill_cand`` selection for each of B
members and one batched 4-release walk, at B = 1, 2, 4, 8 and 16; and the
solo fused call and walk on one member's row.  Each is timed by the host
clock around the call (median of 200; the call returns once its answers are
in host memory) and by its device time a call from torch.profiler, the
variants in turns so that clock drift falls on all.  Every answer is held to
the batched plain version.  Prints one JSON line per (variant, entry, B),
then the card's name and power limit.

Variants, each one text change of the source:
  upload   unchanged: the requests copied into a device buffer with
           cudaMemcpyAsync on the launch's stream, then read from device
           memory, each CTA its own, once
  mapped   the kernel reads its requests from mapped pinned host memory
           instead (the first design; no copy)
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "queue_select_split"
J = 10_000
SIZES = (1, 2, 4, 8, 16)
CALLS = 200

MAPPED = [
    ("  DeviceBuffer& d = request_buffer();\n"
     "  const int bad = ensure_device(d, bytes);\n"
     "  if (bad != 0) return bad;\n"
     "  memcpy(m.host, args, bytes);\n"
     "  const cudaError_t err =\n"
     "      cudaMemcpyAsync(d.ptr, m.host, bytes, cudaMemcpyHostToDevice, s);\n"
     "  if (err != cudaSuccess) return (int)err;\n"
     "  *reqs = static_cast<const SelectArgs*>(d.ptr);\n",
     "  memcpy(m.host, args, bytes);\n"
     "  *reqs = reinterpret_cast<const SelectArgs*>(m.dev);\n"),
    ("        reinterpret_cast<const int32_t*>(reqs + r)[threadIdx.x];",
     "        reinterpret_cast<const volatile int32_t*>(reqs + r)[threadIdx.x];"),
]
VARIANTS = {"upload": [], "mapped": MAPPED}


def build_variants(_build) -> dict:
    """Write and build every variant, one nvcc each, all at once."""
    src = (_build.KERNELS_DIR / "queue_select/csrc/queue_select.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 "source exactly once")
            text = text.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        libs[name] = so
    return libs


def device(torch, cs, fn, calls: int = 50):
    """Device time (us) and device operations a call, over ``calls``
    profiled calls; ``(None, None)`` when the profiler shows none."""
    dev, _ = cs.profiled(torch, lambda: [fn() for _ in range(calls)])
    if not dev:
        return None, None
    return (sum(us for _, us in dev.values()) / calls,
            sum(k for k, _ in dev.values()) / calls)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.queue_select import ops, ref

    if not torch.cuda.is_available():
        print("queue_select_batch_split: no CUDA device", file=sys.stderr)
        return 1
    libs = {n: ops.bind(ctypes.CDLL(str(p)))
            for n, p in build_variants(_build).items()}
    rng = np.random.default_rng(0)
    table, jstate, rsv, clock = cs.stacked_table(torch, np, rng, J,
                                                 (0.01,) * max(SIZES))
    nodes = table.cols["nodes"]
    selects, walks, plain = [], [], []
    for b in range(max(SIZES)):
        order = torch.sort(torch.where(
            jstate[b] == 2, torch.clamp(rsv[b], min=clock + 1), cs.BIG),
            stable=True)[1]
        need = int((3 + torch.cumsum(nodes[b][order], 0))[cs.WALK_STEPS - 1])
        p = cs.select_params(ref, cs.member_table(ops, table, b), jstate[b],
                             rsv[b], clock, 3, need)
        selects.append((b, ref.BACKFILL_CAND, ref.params(**p)))
        walks.append((b, ref.params(clock=clock, free=3, head_need=need)))
        plain.append((ref.fused_select_reference(ref.BACKFILL_CAND,
                                                 {c: t[b] for c, t in
                                                  table.cols.items()},
                                                 jstate[b], **p),
                      ref.shadow_walk_reference(nodes[b], jstate[b], rsv[b],
                                                clock, 3, need)))
    solo = cs.member_table(ops, table, 0)
    solo_calls = {
        "select": lambda: solo.select(ref.BACKFILL_CAND, jstate[0],
                                      *selects[0][2][:-1]),
        "walk": lambda: ops.shadow_walk(solo, jstate[0], rsv[0], clock, 3,
                                        walks[0][1][-1])}
    rows = {}
    for rep in range(2):                  # variants in turns, twice
        for name, lib in libs.items():
            table._lib = lib
            for B in SIZES:
                calls = {"select": lambda: table.select_batch(selects[:B],
                                                              jstate),
                         "walk": lambda: table.walk_batch(walks[:B], jstate,
                                                          rsv)}
                for what, fn in calls.items():
                    want = [p[0 if what == "select" else 1] for p in plain[:B]]
                    if fn() != want:
                        raise SystemExit(f"{name} {what} B={B}: kernel != "
                                         "plain")
                    r = rows.setdefault((name, what, B), {
                        "variant": name, "entry": what, "members": B,
                        "ms": [], "device_us": []})
                    r["ms"].append(cs.wall_ms(fn, CALLS))
                    us, r["device_ops_per_call"] = device(torch, cs, fn)
                    r["device_us"].append(us)
        for what, fn in solo_calls.items():
            r = rows.setdefault(("solo", what, 1), {
                "variant": "solo kernel", "entry": what, "members": 1,
                "ms": [], "device_us": []})
            r["ms"].append(cs.wall_ms(fn, CALLS))
            us, r["device_ops_per_call"] = device(torch, cs, fn)
            r["device_us"].append(us)
    for r in rows.values():
        print(json.dumps(r), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.time()
    rc = main()
    print(json.dumps({"seconds": time.time() - t0}), file=sys.stderr)
    sys.exit(rc)
