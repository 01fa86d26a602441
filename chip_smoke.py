#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time:

1. env     - the card (name and power limit from nvidia-smi), torch and
             CUDA versions; the compute capability must be (9, 0).
2. build   - every CUDA kernel of the port, compiled from the sources in
             this checkout with nvcc (one process per source, in parallel).
3. kernel  - queue_select on the card against its plain PyTorch version,
             bit for bit, over sizes, feasibility rates, negative scores,
             ties and the feasible-BIG corner; then its time (median of
             CUDA-event-timed launches) beside the plain version, a
             two-call PyTorch yardstick and the memory-bandwidth bound.
4. golden  - the engine on cuda, 10,000-job SDSC-SP2-like (six policies)
             and DAS-2-like (fcfs, backfill) traces, each held to the JAX
             engine's n_events, makespan and start/finish digests in
             tests/data/torch_port_golden.json; events/s per run.
5. archive - backfill over 73,496 SDSC-SP2-like jobs on 128 nodes (the
             SDSC-SP2 log's job count on its machine), checked for
             completion, start >= submit, finish == start + runtime and a
             busy-node count that never exceeds the machine.

The queue_select launch counter is set to 0 before each run of phases 4
and 5 and read after it; a run that did not launch the kernel fails.  The
script catches nothing: any failed check exits non-zero.  The last lines
are the kernels table, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.json"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BIG = 2**30 - 1
TIMED_LAUNCHES = 200
ARCHIVE_JOBS = 73_496            # SDSC-SP2 log's job count
ARCHIVE_NODES = 128
PROFILE_JOBS = 250


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3),
                      **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<i4").tobytes()
                          ).hexdigest()


def time_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Median of ``n`` calls, each timed with a CUDA event pair."""
    import torch
    for _ in range(10):
        fn()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_events(prof) -> dict:
    """``{name: (count, total_us)}`` over the device-side events (kernels,
    copies, memsets) of a torch.profiler run.  Host-side ops are left out:
    their device time repeats that of the kernels they launched."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return out


def profiled(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t) * 1e6
    return device_events(prof), wall_us


def phase_kernel(torch, np, ops, ref):
    t0 = time.time()
    rng = np.random.default_rng(0)
    dev = "cuda"
    n_checks, max_err = 0, 0

    def compare(scores, feas):
        nonlocal n_checks, max_err
        s = torch.from_numpy(scores).to(dev)
        for mask in (torch.from_numpy(feas).to(dev),
                     torch.from_numpy(feas.astype(np.int32)).to(dev)):
            got = ops.queue_select(s, mask)
            want = ref.queue_select_reference(s, mask)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            check(err == 0, f"queue_select N={scores.size} "
                  f"mask={mask.dtype}: {got.tolist()} != {want.tolist()}")
            max_err = max(max_err, err)
            n_checks += 1

    for n in (7, 1000, 10_000, ARCHIVE_JOBS, 1_048_576):
        for rate in (0.0, 0.05, 0.5, 1.0):
            feas = rng.random(n) < rate
            # negative scores and many ties: 2,001 distinct values
            compare(rng.integers(-1000, 1001, n).astype(np.int32), feas)
            big = np.full(n, BIG, np.int32)   # feasible entries scoring BIG
            compare(big, feas)
    compare(np.array([-5], np.int32), np.array([True]))
    compare(np.array([3], np.int32), np.array([False]))

    # timing at the archive run's shape: N rows, bool mask, half feasible
    n = ARCHIVE_JOBS
    s = torch.from_numpy(rng.integers(0, 10**6, n).astype(np.int32)).to(dev)
    m = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    # (score, index) packed so that int64 order is lexicographic order
    key = (s.to(torch.int64) << 32) | torch.arange(n, device=dev)
    sentinel = torch.iinfo(torch.int64).max
    kernel_ms = time_ms(lambda: ops.queue_select(s, m))
    plain_ms = time_ms(lambda: ref.queue_select_reference(s, m))
    library_ms = time_ms(lambda: torch.min(torch.where(m, key, sentinel)))
    calls = 100
    dev, _ = profiled(torch, lambda: [ops.queue_select(s, m)
                                      for _ in range(calls)])
    reduce_us = [us / k for name, (k, us) in dev.items()
                 if "select_reduce" in name]
    device_us = sum(us for _, us in dev.values()) / calls
    bytes_moved = n * (4 + 1) + 2 * 4     # scores + bool mask read, i32[2]
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops.queue_select.launches = 0
    timing = {"n": n, "mask": "bool", "kernel_ms": kernel_ms,
              "device_us_per_call": device_us if dev else "not measured",
              "reduce_device_us": reduce_us[0] if reduce_us
              else "not measured",
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library_call": "torch.min(torch.where(feasible, packed_key, "
                              "INT64_MAX)): two calls, packed key built "
                              "outside the timing",
              "bytes": bytes_moved, "bound_ms": bound_ms,
              "bound_us": bound_ms * 1e3}
    emit("kernel", t0, checks=n_checks, max_abs_err=max_err, **timing)
    return max_err, timing


def run_counted(rt, ops, scn):
    """One engine run on cuda with the kernel's launch count around it."""
    import torch
    ops.queue_select.launches = 0
    t = time.time()
    res = rt.run(scn, device="cuda")
    out = res.to_np()
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = ops.queue_select.launches
    check(launches > 0, f"{scn.policy} run launched no queue_select kernel")
    return out, wall, launches


def phase_golden(rt, ops):
    t0 = time.time()
    entries = json.loads(GOLDEN.read_text())["runs"]
    launches = 0
    for e in entries:
        scn = rt.Scenario(
            trace=rt.SyntheticTrace(n_jobs=e["n_jobs"], seed=e["seed"],
                                    kind=e["kind"]),
            total_nodes=e["total_nodes"], policy=e["policy"])
        out, wall, n = run_counted(rt, ops, scn)
        launches += n
        v = out["valid"]
        got = {"n_events": out["n_events"], "makespan": out["makespan"],
               "start_sha256": digest(out["start"][v]),
               "finish_sha256": digest(out["finish"][v])}
        for k, want in got.items():
            check(want == e[k], f"{e['kind']}/{e['policy']}: {k} {want} "
                  f"!= golden {e[k]}")
        emit("golden", t0, kind=e["kind"], policy=e["policy"],
             n_jobs=e["n_jobs"], total_nodes=e["total_nodes"],
             n_events=out["n_events"], run_seconds=wall,
             events_per_s=out["n_events"] / wall, launches=n,
             matches_jax=True)
    return launches


def phase_archive(rt, ops, np):
    t0 = time.time()
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=ARCHIVE_JOBS, seed=1,
                                              kind="sdsc_sp2"),
                      total_nodes=ARCHIVE_NODES, policy="backfill")
    out, wall, launches = run_counted(rt, ops, scn)
    v = out["valid"]
    sub, st, fin, run, nodes = (out[k][v].astype(np.int64) for k in
                                ("submit", "start", "finish", "runtime",
                                 "nodes"))
    check(bool(out["done"][v].all()), "archive run left jobs unfinished")
    check(bool((st >= sub).all()), "a job started before its submit")
    check(bool((fin == st + run).all()), "finish != start + runtime")
    # busy-node sweep: releases sort before starts at the same instant
    t = np.concatenate([fin, st])
    d = np.concatenate([-nodes, nodes])
    order = np.lexsort((d, t))
    peak = int(np.cumsum(d[order]).max())
    check(peak <= ARCHIVE_NODES, f"busy nodes peaked at {peak}")
    emit("archive", t0, policy="backfill", n_jobs=int(v.sum()),
         total_nodes=ARCHIVE_NODES, n_events=out["n_events"],
         run_seconds=wall, events_per_s=out["n_events"] / wall,
         makespan=out["makespan"], peak_busy_nodes=peak, launches=launches)
    return launches


def phase_profile(torch, rt):
    """One short backfill run under torch.profiler: the card's busy share
    of the run's wall time (which the profiler itself lengthens).  Kept
    short because the profiler's post-processing grows with the op
    count."""
    t0 = time.time()
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=PROFILE_JOBS, seed=1,
                                              kind="sdsc_sp2"),
                      total_nodes=ARCHIVE_NODES, policy="backfill")
    dev, wall_us = profiled(torch, lambda: rt.run(scn, device="cuda").to_np())
    busy_us = sum(us for _, us in dev.values())
    top = sorted(dev.items(), key=lambda kv: kv[1][1], reverse=True)[:5]
    emit("profile", t0, n_jobs=PROFILE_JOBS, policy="backfill",
         wall_s=wall_us / 1e6, device_busy_s=busy_us / 1e6,
         device_busy_share=busy_us / wall_us if dev else "not measured",
         device_events=sum(k for k, _ in dev.values()),
         top_device_us={name[:60]: us for name, (_, us) in top})


def main() -> int:
    t_all = time.time()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.exists():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch and tests/data are missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import repro_torch as rt
    from repro_torch.kernels import _build
    from repro_torch.kernels.queue_select import ops, ref

    t0 = time.time()
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    emit("env", t0, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, capability=list(cap),
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0)")

    t0 = time.time()
    logs = _build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", t0, sources=list(logs), ptxas=ptxas)

    max_err, timing = phase_kernel(torch, np, ops, ref)
    launches = phase_golden(rt, ops) + phase_archive(rt, ops, np)
    phase_profile(torch, rt)

    print(json.dumps({"kernels": [{
        "name": "queue_select",
        "route": "cuda",
        "source": "src/repro_torch/kernels/queue_select/csrc/queue_select.cu",
        "replaces": "src/repro/kernels/queue_select/kernel.py:23",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["kernel_ms"],
        "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_us": timing["bound_us"],
        "bound_by": "bytes",
        "library_ms": timing["library_ms"],
        "shape": f"N={timing['n']}, bool mask",
        "device_us_per_call": timing["device_us_per_call"],
        "reduce_device_us": timing["reduce_device_us"],
    }]}), flush=True)
    emit("total", t_all)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
