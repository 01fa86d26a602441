#!/usr/bin/env python3
"""Does torch.profiler drop device events at the edges of its window?

    python3 scripts/profiler_window.py [--profiles 40] [--calls 50]
                                       [--pad-s 0.02]

The profiler keeps a device event only if it lies inside the capture
window, whose ends are taken on the host's clock, while the device events
carry the card's timestamps converted to that clock.  A call made right
after the profile starts, or ending right before it stops, can then fall
outside and be lost.  This script profiles ``--calls`` calls of a small
synchronous step (an upload from pinned memory, one kernel, a stream
wait: two device operations, as a batched ``queue_select`` call makes)
``--profiles`` times with no host-only time at the window's ends and as
many times with ``--pad-s`` seconds at each end, interleaved, and prints
one JSON line: the device operations each profile counted in both
settings, and the least and greatest gap between a device operation's
start and the start of the host call that enqueued it (a negative gap is
the device's clock running behind the host's).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time


def profile_once(torch, step, calls: int, pad_s: float):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if pad_s:
            torch.cuda.synchronize()
            time.sleep(pad_s)
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    host = {e.correlation_id(): e for e in events
            if e.device_type() == DeviceType.CPU
            and e.name().startswith("cuda") and e.correlation_id() > 0}
    gaps = [(e.start_ns() - host[e.correlation_id()].start_ns()) / 1e3
            for e in device if e.correlation_id() in host]
    return len(device), gaps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiles", type=int, default=40)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--pad-s", type=float, default=0.02)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profiler_window: no CUDA device")
    src = torch.arange(512, dtype=torch.int32).pin_memory()
    dst = torch.empty(512, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream()

    def step():
        dst.copy_(src, non_blocking=True)
        dst.add_(1)
        stream.synchronize()

    for _ in range(20):
        step()
    counts = {"unpadded": [], "padded": []}
    gaps = []
    for _ in range(args.profiles):
        for kind, pad in (("unpadded", 0.0), ("padded", args.pad_s)):
            n, g = profile_once(torch, step, args.calls, pad)
            counts[kind].append(n)
            gaps += g
    want = 2 * args.calls
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "calls": args.calls, "expected": want, "pad_s": args.pad_s,
        **{f"{k}_counts": v for k, v in counts.items()},
        **{f"{k}_short": sum(n < want for n in v) for k, v in counts.items()},
        "gaps_linked": len(gaps),
        "min_gap_us": min(gaps) if gaps else None,
        "max_gap_us": max(gaps) if gaps else None}), flush=True)


if __name__ == "__main__":
    main()
