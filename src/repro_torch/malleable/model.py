"""Malleable jobs of the PyTorch port: moldable width choice and elastic
grow/shrink (DESIGN.md §17, two-level resource management).

Counterpart of ``repro.malleable.model``.  A :class:`MalleableModel` is a
frozen host spec of a speedup curve (Amdahl with ``param`` the serial
fraction, a power law ``S(w) = w**param``, or a table of per-width
efficiencies) over a global ``[min_width, max_width]`` range, and a mode:

- ``"moldable"``: the scheduler picks each job's width once, at dispatch:
  the placeable width with the least dilated runtime, ties to the
  narrowest;
- ``"elastic"``: moldable dispatch, plus grow/shrink of running jobs at
  resize ticks under queue pressure, and a node failure that sheds one node
  of a job with width to give instead of killing it.

:func:`materialize_plan` lowers the spec against a trace to a padded
per-job table ``dur[j, k] = ceil(runtime_j * S(nref_j) / S(min_width +
k))``, row-aligned with the sorted job table (it repeats ``make_jobset``'s
normalization), and :func:`make_mal_ctx` turns it into the engine's host
context :class:`MalCtx`.  The tables stay on the host: the engine's width
choices, resizes and re-dilations are host arithmetic over them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core.jobs import INF_TIME

_CURVES = ("amdahl", "power", "table")
_MODES = ("moldable", "elastic")


@dataclasses.dataclass(frozen=True)
class MalleableModel:
    """Frozen malleability spec for a :class:`repro_torch.api.Scenario`.

    ``curve``/``param``/``table`` pick the speedup curve ``S(w)``:

    - ``"amdahl"``: ``S(w) = 1 / (param + (1 - param) / w)`` with
      ``param`` the serial fraction in ``[0, 1]``;
    - ``"power"``: ``S(w) = w ** param`` with ``param`` in ``(0, 1]``;
    - ``"table"``: ``S(w) = w * table[w - min_width]`` with ``table`` the
      per-width parallel efficiency in ``(0, 1]``, one entry per width.

    Every job's reference width is its (clamped) node request; running at
    width ``w`` dilates its runtime by ``S(nref) / S(w)``.  In
    ``"elastic"`` mode, resize ticks at ``k * interval`` (``k = 1 ..
    max_ticks``) compare the queued node demand with the hysteresis band:
    demand ``>= shrink_threshold`` shrinks the widest running job by up to
    ``step`` nodes, demand ``<= grow_threshold`` grows the narrowest one
    into idle nodes.  ``min_width``, ``max_width``, ``mode`` and
    ``max_ticks`` fix a sweep bucket; the rest is data.
    """

    curve: str = "amdahl"
    param: float = 0.1
    table: Optional[Tuple[float, ...]] = None
    min_width: int = 1
    max_width: int = 8
    mode: str = "moldable"
    interval: int = 60
    max_ticks: int = 256
    shrink_threshold: int = 1
    grow_threshold: int = 0
    step: int = 1

    def __post_init__(self):
        if self.curve not in _CURVES:
            raise ValueError(
                f"unknown curve {self.curve!r}; known: {_CURVES}")
        if self.curve == "amdahl" and not 0.0 <= self.param <= 1.0:
            raise ValueError(
                f"amdahl serial fraction must be in [0, 1], got {self.param}")
        if self.curve == "power" and not 0.0 < self.param <= 1.0:
            raise ValueError(
                f"power-law alpha must be in (0, 1], got {self.param}")
        if not 1 <= self.min_width <= self.max_width:
            raise ValueError(
                f"need 1 <= min_width <= max_width, got "
                f"[{self.min_width}, {self.max_width}]")
        if self.curve == "table":
            n_w = self.max_width - self.min_width + 1
            if self.table is None or len(self.table) != n_w:
                raise ValueError(
                    f"table curve needs one efficiency per width "
                    f"({n_w} entries for [{self.min_width}, "
                    f"{self.max_width}]), got "
                    f"{None if self.table is None else len(self.table)}")
            if any(not 0.0 < e <= 1.0 for e in self.table):
                raise ValueError("table efficiencies must lie in (0, 1]")
        elif self.table is not None:
            raise ValueError("table is only meaningful with curve='table'")
        if self.mode not in _MODES:
            raise ValueError(f"unknown mode {self.mode!r}; known: {_MODES}")
        if self.mode == "elastic":
            if self.interval < 1:
                raise ValueError("interval must be >= 1")
            if self.max_ticks < 1:
                raise ValueError("elastic mode needs max_ticks >= 1")
            if self.step < 1:
                raise ValueError("step must be >= 1")
            if (self.grow_threshold < 0
                    or self.shrink_threshold <= self.grow_threshold):
                raise ValueError(
                    "hysteresis requires 0 <= grow_threshold < "
                    f"shrink_threshold, got grow={self.grow_threshold} "
                    f"shrink={self.shrink_threshold}")

    def static_key(self) -> tuple:
        """A sweep bucket's share: the width range, the mode and the tick
        capacity (curve, parameters, interval and thresholds are data)."""
        return ("malleable", self.min_width, self.max_width, self.mode,
                self.max_ticks if self.mode == "elastic" else 0)

    def speedup(self, widths: np.ndarray) -> np.ndarray:
        """``S(w)`` over an array of widths (float64)."""
        w = np.asarray(widths, dtype=np.float64)
        if self.curve == "amdahl":
            f = float(self.param)
            return 1.0 / (f + (1.0 - f) / w)
        if self.curve == "power":
            return w ** float(self.param)
        eff = np.asarray(self.table, dtype=np.float64)
        return w * eff[np.asarray(widths, dtype=np.int64) - self.min_width]


@dataclasses.dataclass(frozen=True, eq=False)
class MalleablePlan:
    """A materialized plan (host arrays).  ``dur[j, k]`` is job *j*'s
    dilated runtime at width ``min_width + k``, row-aligned with the
    (submit, id)-sorted padded job table; ``nref[j]`` its reference width
    (padding rows: dur 1, nref ``min_width``).  ``tick_time`` is the elastic
    resize stream (length 0 in moldable mode)."""

    dur: np.ndarray        # i32[J_cap, W] dilated runtime per width
    nref: np.ndarray       # i32[J_cap] reference (requested) width
    tick_time: np.ndarray  # i32[T] resize ticks; [0] = moldable
    min_width: int
    max_width: int
    step: int
    shrink_threshold: int
    grow_threshold: int
    n_jobs: int            # real (unpadded) job count

    @property
    def capacity(self) -> int:
        return int(self.dur.shape[0])

    @property
    def n_widths(self) -> int:
        return int(self.dur.shape[1])


def materialize_plan(model: MalleableModel, trace: Dict[str, np.ndarray], *,
                     total_nodes: int,
                     capacity: Optional[int] = None) -> MalleablePlan:
    """Lower a :class:`MalleableModel` against a concrete job trace.

    Repeats ``make_jobset``'s normalization (0-based submit, >= 1 clamps,
    node requests capped at the machine, (submit, id) order, padding), so
    the plan's rows align with the job table's.  Raises when the dilated
    horizon overflows the int32 clock, or the node-second ledger its int32
    accumulator, at the reference's boundaries.
    """
    if model.min_width > int(total_nodes):
        raise ValueError(
            f"min_width={model.min_width} exceeds the machine "
            f"({total_nodes} nodes); no malleable job could ever start")

    submit = np.asarray(trace["submit"], dtype=np.int64)
    runtime = np.asarray(trace["runtime"], dtype=np.int64)
    nodes = np.asarray(trace["nodes"], dtype=np.int64)
    est = trace.get("estimate")
    estimate = (np.asarray(est, dtype=np.int64) if est is not None
                else runtime.copy())
    n = submit.shape[0]
    submit = submit - (submit.min() if n else 0)
    runtime = np.maximum(runtime, 1)
    estimate = np.maximum(estimate, 1)
    nodes = np.minimum(np.maximum(nodes, 1), int(total_nodes))
    order = np.lexsort((np.arange(n), submit))
    submit, runtime, estimate, nodes = (
        submit[order], runtime[order], estimate[order], nodes[order])

    wlo, whi = model.min_width, model.max_width
    widths = np.arange(wlo, whi + 1, dtype=np.int64)
    s_w = model.speedup(widths)
    nref = np.clip(nodes, wlo, whi)
    s_ref = s_w[nref - wlo]
    # exact runtime at w == nref: the float64 ratio is exactly 1.0 there
    ratio = s_ref[:, None] / s_w[None, :]
    dur = np.maximum(np.ceil(runtime[:, None] * ratio), 1.0)

    dur_max = int(dur.max(initial=1.0))
    top = int(submit.max(initial=0)) + 2 * max(dur_max,
                                               int(estimate.max(initial=1)))
    if top >= INF_TIME:
        raise ValueError(
            f"dilated trace horizon overflows the int32 clock: max arrival "
            f"{int(submit.max(initial=0))} + dilated runtimes reaches {top} "
            f">= {INF_TIME}; rescale the trace or widen min_width")
    if whi * top >= 2**31:
        raise ValueError(
            f"node-second accumulator overflows int32: max_width={whi} * "
            f"horizon {top} reaches {whi * top} >= {2**31}; rescale the "
            "trace or narrow max_width")

    cap = int(capacity) if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < number of jobs {n}")
    W = whi - wlo + 1
    dur_pad = np.ones((cap, W), dtype=np.int32)
    dur_pad[:n] = dur.astype(np.int32)
    nref_pad = np.full((cap,), wlo, dtype=np.int32)
    nref_pad[:n] = nref.astype(np.int32)

    if model.mode == "elastic":
        ticks = np.arange(1, model.max_ticks + 1, dtype=np.int64) \
            * model.interval
        tick_time = np.minimum(ticks, INF_TIME).astype(np.int32)
    else:
        tick_time = np.zeros((0,), dtype=np.int32)

    return MalleablePlan(
        dur=dur_pad, nref=nref_pad, tick_time=tick_time,
        min_width=int(wlo), max_width=int(whi), step=int(model.step),
        shrink_threshold=int(model.shrink_threshold),
        grow_threshold=int(model.grow_threshold), n_jobs=n,
    )


class MalCtx(NamedTuple):
    """A run's malleable plan as the engine consumes it, on the host: the
    ``dur`` table (i32[J, W]), the reference widths ``nref`` (i32[J]), the
    resize ticks ``tick_time`` (i32[T], T = 0 in moldable mode) and the
    scalars as Python ints."""

    dur: np.ndarray
    nref: np.ndarray
    tick_time: np.ndarray
    min_width: int
    max_width: int
    step: int
    shrink_threshold: int
    grow_threshold: int

    @property
    def n_widths(self) -> int:
        return int(self.dur.shape[-1])

    @property
    def elastic(self) -> bool:
        """Whether the plan resizes running jobs (a tick stream), which
        also turns a failure's kill into a shrink where it can."""
        return self.tick_time.shape[-1] > 0


def make_mal_ctx(malleable) -> Optional[MalCtx]:
    """Canonicalize a ``malleable`` argument into the engine's
    :class:`MalCtx`, or ``None``.

    Accepts ``None`` (the engine runs rigid jobs), a
    :class:`MalleablePlan`, or an 8-tuple ``(dur, nref, tick_time,
    min_width, max_width, step, shrink_threshold, grow_threshold)`` (a
    ``MalCtx`` among them).  Everything stays on the host.
    """
    if malleable is None:
        return None
    if isinstance(malleable, MalleablePlan):
        malleable = (malleable.dur, malleable.nref, malleable.tick_time,
                     malleable.min_width, malleable.max_width,
                     malleable.step, malleable.shrink_threshold,
                     malleable.grow_threshold)
    if not (isinstance(malleable, tuple) and len(malleable) == 8):
        raise TypeError(
            "malleable must be None, a MalleablePlan, or an 8-tuple mal "
            f"ctx; got {type(malleable).__name__}")
    arrays = tuple(np.ascontiguousarray(x, dtype=np.int32)
                   for x in malleable[:3])
    return MalCtx(*arrays, *(int(x) for x in malleable[3:]))
