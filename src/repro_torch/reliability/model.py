"""Deterministic node-failure models of the PyTorch port (DESIGN.md §15).

Counterpart of ``repro.reliability.model``, with the same streams bit for
bit.

A :class:`FailureModel` is a frozen host-side spec of a cluster's
reliability behaviour: every node runs an independent renewal process —
up for a seeded exponential (or Weibull) draw, down for a seeded
exponential repair draw, repeat — so a node can never fail while it is
already down.  ``materialize(n_nodes)`` lowers the spec to a
:class:`FailureTrace`: three *padded, fixed-shape* host arrays
(``fail_time``/``fail_node``/``repair_time``, ``INF_TIME`` in the padding
slots) plus the integer kill-policy knobs.  The engine consumes them
through :func:`make_fail_ctx`, which merges them with :func:`merge_stream`
into one host stream: one stable sort by timestamp over the concatenated
``[failures..., repairs...]`` lists (ties therefore break fail-first, then
by event index).  The stream stays on the host, where the event loop reads
the next entry's time without a device round trip; ``max_failures`` is the
one field that changes a sweep's bucket.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

# The int32 "infinite time" sentinel, == repro_torch.core.jobs.INF_TIME
# (that module is not imported here at module scope: the engine imports
# this module — asserted equal at the first materialization instead).
INF_TIME = np.int32(2**30 - 1)

# stream event kinds (pinned in both engines)
FAIL = 0
REPAIR = 1

# kill-policy ids (``FailureTrace.requeue``)
ABORT = 0
REQUEUE = 1
REQUEUE_IDS = {"abort": ABORT, "requeue": REQUEUE}
REQUEUE_NAMES = {v: k for k, v in REQUEUE_IDS.items()}

_DISTRIBUTIONS = ("exponential", "weibull")


@dataclasses.dataclass(frozen=True, eq=False)
class FailureTrace:
    """Materialized failure/repair streams (host arrays, padded).

    ``fail_time[f]`` is when node ``fail_node[f]`` goes down and
    ``repair_time[f]`` when that same node comes back up; entries are
    sorted by (fail_time, node) with ``INF_TIME`` padding at the tail, so
    the padded capacity ``fail_time.shape[-1]`` is the only static shape.
    A failure and its repair are always kept or dropped together — a
    materialized trace never strands a node down forever.
    """

    fail_time: np.ndarray    # i32[F], INF_TIME = padding
    fail_node: np.ndarray    # i32[F]
    repair_time: np.ndarray  # i32[F]
    requeue: int             # REQUEUE or ABORT
    checkpoint_interval: int  # 0 = no checkpoints (full rework on kill)
    restart_overhead: int
    n_failures: int          # real (unpadded) failure count
    truncated: bool = False  # renewal generated > max_failures pairs

    @property
    def capacity(self) -> int:
        return int(self.fail_time.shape[-1])


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Frozen reliability spec for a :class:`repro_torch.api.Scenario`.

    ``mtbf`` is the per-node scale of the up-time distribution (the mean
    for ``exponential``; for ``weibull`` the scale parameter, with shape
    ``k``).  ``mean_repair`` is the mean of the exponential down-time
    draw.  ``requeue`` picks what happens to a job killed by a node
    failure: ``"requeue"`` re-enters the queue at its original submit
    rank with its lost work re-charged (bounded by
    ``checkpoint_interval``: work since the last checkpoint is lost, plus
    ``restart_overhead``), ``"abort"`` terminates it (dependents release
    with after-any semantics).  ``max_failures`` is the padded event
    capacity — the one field that changes compiled shapes; everything
    else is trace *data*, so ``sweep()`` batches MTBF / checkpoint /
    requeue grids into one executable.
    """

    mtbf: float
    seed: int = 0
    distribution: str = "exponential"
    k: float = 1.5                 # weibull shape (ignored for exponential)
    mean_repair: int = 60
    horizon: int = 1 << 20         # failures generated in [0, horizon)
    max_failures: int = 64         # padded capacity (static shape)
    requeue: str = "requeue"
    checkpoint_interval: int = 0   # 0 = no checkpoints (full rework)
    restart_overhead: int = 0

    def __post_init__(self):
        if not self.mtbf > 0:
            raise ValueError(f"mtbf must be positive, got {self.mtbf}")
        if self.distribution not in _DISTRIBUTIONS:
            raise ValueError(
                f"unknown distribution {self.distribution!r}; "
                f"known: {_DISTRIBUTIONS}")
        if not self.k > 0:
            raise ValueError(f"weibull shape k must be positive, got {self.k}")
        if self.mean_repair < 1:
            raise ValueError("mean_repair must be >= 1")
        if self.requeue not in REQUEUE_IDS:
            raise ValueError(
                f"requeue must be one of {sorted(REQUEUE_IDS)}, "
                f"got {self.requeue!r}")
        if self.max_failures < 0:
            raise ValueError("max_failures must be >= 0")
        if self.checkpoint_interval < 0 or self.restart_overhead < 0:
            raise ValueError(
                "checkpoint_interval/restart_overhead must be >= 0")
        if not 0 < self.horizon < int(INF_TIME) // 2:
            raise ValueError(
                f"horizon must be in (0, {int(INF_TIME) // 2}) so failure "
                "and repair timestamps stay clear of the int32 sentinel")

    def static_key(self) -> tuple:
        """The compile-bucket contribution: only the padded capacity
        changes the stacked shapes (``repro_torch.api.sweep`` keys on
        this)."""
        return ("failures", self.max_failures)

    def materialize(self, n_nodes: int) -> FailureTrace:
        """Deterministic (seed, n_nodes)-keyed failure/repair streams."""
        return _materialize(self, int(n_nodes))


@functools.lru_cache(maxsize=256)
def _materialize(model: FailureModel, n_nodes: int) -> FailureTrace:
    from repro_torch.core.jobs import INF_TIME as _engine_inf

    assert INF_TIME == _engine_inf, \
        "sentinel drifted from repro_torch.core.jobs"
    rng = np.random.default_rng(model.seed)
    events: list[tuple[int, int, int]] = []   # (t_fail, node, t_repair)
    for node in range(n_nodes):
        t = 0
        for _ in range(model.max_failures):
            u = rng.random()
            if model.distribution == "exponential":
                dt = -model.mtbf * math.log1p(-u)
            else:
                dt = model.mtbf * (-math.log1p(-u)) ** (1.0 / model.k)
            t_fail = t + max(1, int(math.ceil(dt)))
            if t_fail >= model.horizon:
                break
            r = -model.mean_repair * math.log1p(-rng.random())
            t_repair = min(t_fail + max(1, int(math.ceil(r))),
                           int(INF_TIME) - 1)
            events.append((t_fail, node, t_repair))
            t = t_repair
    events.sort()                              # (fail_time, node) order
    truncated = len(events) > model.max_failures
    if truncated:
        # keeping only the earliest pairs concentrates every failure at the
        # start of the horizon — an MTBF sweep whose points all saturate
        # measures the truncation, not reliability.  Loud, once per
        # (model, n_nodes) thanks to the lru cache.
        import warnings

        warnings.warn(
            f"FailureModel(mtbf={model.mtbf}, horizon={model.horizon}) "
            f"generated {len(events)} failures for {n_nodes} nodes but "
            f"max_failures={model.max_failures}; keeping only the earliest "
            f"{model.max_failures} — raise max_failures (or mtbf/horizon) "
            "unless early-window truncation is intended",
            stacklevel=3)
    events = events[:model.max_failures]       # keep the earliest pairs
    F = model.max_failures
    fail_time = np.full((F,), INF_TIME, dtype=np.int32)
    fail_node = np.zeros((F,), dtype=np.int32)
    repair_time = np.full((F,), INF_TIME, dtype=np.int32)
    for i, (tf, node, tr) in enumerate(events):
        fail_time[i], fail_node[i], repair_time[i] = tf, node, tr
    return FailureTrace(
        fail_time=fail_time, fail_node=fail_node, repair_time=repair_time,
        requeue=REQUEUE_IDS[model.requeue],
        checkpoint_interval=int(model.checkpoint_interval),
        restart_overhead=int(model.restart_overhead),
        n_failures=len(events),
        truncated=truncated,
    )


def merge_stream(trace: FailureTrace) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Host-side (time, node, kind) stream, in the order the engine walks.

    One stable argsort by timestamp over ``[failures..., repairs...]``,
    the permutation of the reference's stable device argsort, so every
    engine walks the same interleaving.  Padding entries (time
    ``INF_TIME``) sort to the tail.
    """
    times = np.concatenate([trace.fail_time, trace.repair_time])
    nodes = np.concatenate([trace.fail_node, trace.fail_node])
    kind = np.concatenate([
        np.full_like(trace.fail_node, FAIL),
        np.full_like(trace.fail_node, REPAIR),
    ])
    order = np.argsort(times, kind="stable")
    return times[order], nodes[order], kind[order]


class FailCtx(NamedTuple):
    """A run's failure stream as the engine consumes it: the merged
    (``time``, ``node``, ``kind``) stream of :func:`merge_stream` (host
    int32 arrays of length ``2 * max_failures``) and the kill-policy
    knobs (host ints)."""

    time: np.ndarray
    node: np.ndarray
    kind: np.ndarray
    requeue: int
    checkpoint_interval: int
    restart_overhead: int

    @property
    def capacity(self) -> int:
        """The padded failure capacity ``F`` (half the stream)."""
        return int(self.time.shape[-1]) // 2


def make_fail_ctx(failures, *, n_nodes: Optional[int] = None
                  ) -> Optional[FailCtx]:
    """Canonicalize a ``failures`` argument into the engine's
    :class:`FailCtx`, or ``None``.

    Accepts ``None`` (the engine runs without the stream), a
    :class:`FailureModel` (materialized against ``n_nodes``), a
    :class:`FailureTrace`, or a ``FailCtx``.  Everything stays on the
    host.
    """
    if failures is None or isinstance(failures, FailCtx):
        return failures
    if isinstance(failures, FailureModel):
        if n_nodes is None:
            raise ValueError(
                "a FailureModel needs total_nodes to materialize; pass a "
                "FailureTrace (or a fail ctx) instead")
        failures = failures.materialize(n_nodes)
    if not isinstance(failures, FailureTrace):
        raise TypeError(
            "failures must be None, a FailureModel, a FailureTrace, or a "
            f"FailCtx (fail ctx); got {type(failures).__name__}")
    time, node, kind = merge_stream(failures)
    return FailCtx(time.astype(np.int32), node.astype(np.int32),
                   kind.astype(np.int32), int(failures.requeue),
                   int(failures.checkpoint_interval),
                   int(failures.restart_overhead))
