"""Standard Workload Format (SWF) parser, hardened for full-archive logs.

The PyTorch port's own copy of ``repro.traces.swf``'s loader (the port
imports nothing of the JAX package); both produce the same columns.

The paper uses GWA-DAS2 (Grid Workloads Archive) and SDSC-SP2 (Parallel
Workloads Archive).  Both distribute SWF: one job per line, 18 whitespace-
separated fields, ';' comment header.  This container is offline, so tests
and benchmarks use the statistical generators in ``synthetic.py``; drop a
real ``.swf``/``.swf.gz`` file in and this loader feeds it straight to the
engines (``repro_torch.replay`` for full archives, one-shot ``simulate``
for trimmed ones).

SWF fields used (1-indexed per the spec):
  1 job id, 2 submit time, 4 run time, 5 allocated processors,
  8 requested processors, 9 requested time (estimate), 11 status.

Archive-grade input is messy, so the loader is an auditor, not a crasher
(DESIGN.md §19): every line lands in exactly one of

- **loaded** — a well-formed row that survives the filters,
- **skipped** — well-formed but filtered by data semantics (non-positive
  runtime or processor count, the classic cancelled/failed encodings),
- **cancelled** — dropped because the SWF status field says 5 (cancelled
  before start; such jobs never consumed resources),
- **quarantined** — malformed (too few fields, non-numeric values,
  negative submit time); lenient mode counts these and keeps going,
  ``strict=True`` raises on the first one with the line number.

``load_swf`` returns ``(trace, report)``: the int64 column dict the
engines consume plus a :class:`SwfReport` of those counters.  Submit
times are rebased to the earliest kept submit (``rebase=False`` keeps raw
log seconds; the raw epoch is preserved in ``report.t0`` either way), and
the report warns — loudly, via ``warnings.warn`` — when any column would
truncate under the engines' int32 downcast.
"""

from __future__ import annotations

import dataclasses
import gzip
import warnings
from typing import Dict, Tuple

import numpy as np

# SWF status-field values (field 11).  Per the spec: 1 = completed, 0 =
# failed, 5 = cancelled.  Failed jobs ran (they consumed resources) and are
# kept when their runtime is positive, matching AccaSim/CQsim replay
# practice; cancelled jobs never started and are dropped.
STATUS_CANCELLED = 5

_I32_MAX = int(np.iinfo(np.int32).max)

# keep at most this many (line_no, reason) samples in the report
_MAX_EXAMPLES = 3


@dataclasses.dataclass(frozen=True)
class SwfReport:
    """Ingestion audit for one ``load_swf`` call (DESIGN.md §19)."""

    path: str
    n_lines: int = 0          # data lines seen (comments/blank excluded)
    n_jobs: int = 0           # rows loaded into the trace
    n_skipped: int = 0        # well-formed rows filtered (runtime/procs <= 0)
    n_quarantined: int = 0    # malformed rows (short/non-numeric/neg submit)
    n_cancelled: int = 0      # rows dropped by SWF status == 5
    t0: int = 0               # earliest kept raw submit (the rebase epoch)
    int32_safe: bool = True   # False => the int32 downcast would truncate
    examples: tuple = ()      # up to 3 (line_no, reason) bad-line samples

    def summary(self) -> str:
        return (f"{self.path}: {self.n_jobs} jobs loaded / {self.n_lines} "
                f"rows ({self.n_skipped} filtered, {self.n_cancelled} "
                f"cancelled, {self.n_quarantined} quarantined)")


def _opener(path: str):
    return gzip.open if str(path).endswith(".gz") else open


def load_swf(
    path: str,
    *,
    max_jobs: int | None = None,
    strict: bool = False,
    rebase: bool = True,
) -> Tuple[Dict[str, np.ndarray], SwfReport]:
    """Parse an SWF log into int64 columns plus an ingestion report.

    Returns ``(trace, report)`` where ``trace`` has ``submit``/``runtime``/
    ``nodes``/``estimate`` int64 arrays and ``report`` is a
    :class:`SwfReport`.  ``strict=True`` raises :class:`ValueError` on the
    first malformed line instead of quarantining it; data-semantics filters
    (non-positive runtime/procs, cancelled status) never raise.  With
    ``rebase=True`` (default) submit times start at 0 and the raw epoch is
    recorded in ``report.t0``.
    """
    submit, runtime, nodes, estimate = [], [], [], []
    n_lines = n_skipped = n_quarantined = n_cancelled = 0
    examples: list[tuple[int, str]] = []

    def bad(lineno: int, reason: str, line: str):
        nonlocal n_quarantined
        if strict:
            raise ValueError(f"{path}:{lineno}: {reason}: {line!r}")
        n_quarantined += 1
        if len(examples) < _MAX_EXAMPLES:
            examples.append((lineno, reason))

    with _opener(path)(path, "rt") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            n_lines += 1
            f = line.split()
            if len(f) < 9:
                bad(lineno, f"expected >= 9 fields, got {len(f)}", line)
                continue
            try:
                sub = int(float(f[1]))
                rt = int(float(f[3]))
                alloc_procs = int(float(f[4]))
                req_procs = int(float(f[7]))
                est = int(float(f[8]))
                status = int(float(f[10])) if len(f) >= 11 else None
            except ValueError:
                bad(lineno, "non-numeric field", line)
                continue
            if sub < 0:
                bad(lineno, f"negative submit time {sub}", line)
                continue
            if status == STATUS_CANCELLED:
                n_cancelled += 1
                continue
            procs = req_procs if req_procs > 0 else alloc_procs
            if rt <= 0 or procs <= 0:
                n_skipped += 1   # failed/zero-width rows, per common practice
                continue
            submit.append(sub)
            runtime.append(rt)
            nodes.append(procs)
            estimate.append(est if est > 0 else rt)
            if max_jobs is not None and len(submit) >= max_jobs:
                break

    trace = {
        "submit": np.asarray(submit, dtype=np.int64),
        "runtime": np.asarray(runtime, dtype=np.int64),
        "nodes": np.asarray(nodes, dtype=np.int64),
        "estimate": np.asarray(estimate, dtype=np.int64),
    }
    t0 = int(trace["submit"].min()) if len(submit) else 0
    if rebase:
        trace["submit"] = trace["submit"] - t0
    top = max((int(v.max()) for v in trace.values() if v.size), default=0)
    int32_safe = top <= _I32_MAX
    if not int32_safe:
        warnings.warn(
            f"{path}: column values up to {top} exceed int32; the one-shot "
            "engine's downcast would truncate — replay this trace through "
            "repro_torch.replay (int64 host clocks) or rescale its time "
            "unit",
            stacklevel=2)
    report = SwfReport(
        path=str(path), n_lines=n_lines, n_jobs=len(submit),
        n_skipped=n_skipped, n_quarantined=n_quarantined,
        n_cancelled=n_cancelled, t0=t0, int32_safe=int32_safe,
        examples=tuple(examples),
    )
    return trace, report


def dump_swf(path: str, trace: Dict[str, np.ndarray], *,
             comment: str | None = None) -> int:
    """Write a trace dict as a standard 18-field SWF file (gzipped when
    the path ends in ``.gz``).

    The inverse of :func:`load_swf` for the fields this project reads
    (submit, runtime, nodes, estimate; unused fields hold -1, status 1),
    so synthetic traces can go through the archive ingestion path.
    Returns the number of rows written."""
    submit = np.asarray(trace["submit"], dtype=np.int64)
    runtime = np.asarray(trace["runtime"], dtype=np.int64)
    nodes = np.asarray(trace["nodes"], dtype=np.int64)
    estimate = np.asarray(trace.get("estimate", runtime), dtype=np.int64)
    n = len(submit)
    with _opener(path)(path, "wt") as fh:
        if comment:
            for ln in comment.splitlines():
                fh.write(f"; {ln}\n")
        fh.write("; job submit wait run alloc_procs avgcpu mem req_procs "
                 "req_time req_mem status uid gid exe queue part prev think\n")
        for i in range(n):
            fh.write(
                f"{i + 1} {submit[i]} -1 {runtime[i]} {nodes[i]} -1 -1 "
                f"{nodes[i]} {estimate[i]} -1 1 -1 -1 -1 -1 -1 -1 -1\n")
    return n
