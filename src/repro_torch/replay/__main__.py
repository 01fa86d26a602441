"""CLI for streaming trace replay with checkpoint/resume.

    python -m repro_torch.replay TRACE.swf[.gz] --nodes 512 [--policy backfill]
        [--window 4096] [--ckpt-dir DIR] [--resume] [--out summary.json]
        [--device cpu]

``--resume`` restarts from the last durable round in ``--ckpt-dir`` (the
trace and configuration must match the interrupted run); the result
equals an uninterrupted one.  The replay runs on ``cuda`` unless
``--device`` names another device.
"""

import argparse
import json
import sys

from repro_torch.replay.runner import StreamingReplay
from repro_torch.traces.swf import load_swf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.replay",
        description="Stream an SWF archive trace through the windowed "
                    "scheduler with durable checkpoints.")
    ap.add_argument("trace", help="path to .swf or .swf.gz log")
    ap.add_argument("--nodes", type=int, required=True,
                    help="cluster size (scalar-counter mode)")
    ap.add_argument("--policy", default="fcfs",
                    help="fcfs | sjf | backfill | preempt (default fcfs)")
    ap.add_argument("--window", type=int, default=4096,
                    help="active-window job slots (doubles on overflow)")
    ap.add_argument("--max-jobs", type=int, default=None,
                    help="replay only the first N loaded jobs")
    ap.add_argument("--strict", action="store_true",
                    help="reject malformed SWF lines instead of quarantining")
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for durable round checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=16,
                    help="checkpoint every K rounds (default 16)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the last durable round in --ckpt-dir")
    ap.add_argument("--out", default=None,
                    help="write the summary JSON here (default stdout)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    if args.resume and args.ckpt_dir is None:
        ap.error("--resume requires --ckpt-dir")
    trace, report = load_swf(args.trace, max_jobs=args.max_jobs,
                             strict=args.strict)
    print(report.summary(), file=sys.stderr)
    runner = StreamingReplay(
        trace, args.policy, total_nodes=args.nodes, window=args.window,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        device=args.device)
    result = runner.run(resume=args.resume)
    text = json.dumps({"trace": report.summary(), **result.summary()},
                      indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
