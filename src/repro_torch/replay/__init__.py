"""Crash-safe streaming replay of full-archive traces (DESIGN.md §19).

``replay_trace`` streams an SWF log (or a trace dict) through bounded
windows, so the device never holds more than the active window, with
durable per-round checkpoints; ``resume`` restarts an interrupted run from
the last durable round and equals an uninterrupted one.  CLI::

    python -m repro_torch.replay TRACE.swf.gz --nodes 512 --policy backfill \\
        --ckpt-dir CKPT [--resume]
"""

from repro_torch.replay.runner import (  # noqa: F401
    ReplayError, ReplayFlags, ReplayInterrupted, ReplayResult,
    StreamingReplay, replay_trace, resume,
)
