"""Online serving traffic of the PyTorch port (DESIGN.md §16).

Counterpart of ``repro.serving.model``, with the same plans bit for bit.

A :class:`ServiceTrace` is a frozen host-side spec of an *open* arrival
process over a bounded horizon: requests arrive Poisson (or via an explicit
trace-driven arrival list), each drawn from a per-class mix — a
:class:`ServiceClass` fixes the node footprint, the runtime distribution
and the class's SLO wait target — and ``materialize()`` lowers the spec to
deterministic, padded job arrays exactly like ``FailureModel`` does for
failure streams.  Arrival rate, class mix, runtimes, deadlines and every
autoscaler threshold are trace *data*: a rate sweep (or an SLO sweep, or
autoscale on/off) runs as one ensemble; the only static axes are the
padded job capacity ``max_jobs`` and the autoscaler's padded tick
capacity ``max_ticks``.

The queue-pressure autoscaler (:class:`AutoscalePolicy`) is a deterministic
capacity event stream: ticks at ``k * interval`` re-evaluate queued node
demand against hysteresis thresholds and move nodes in or out of service,
riding the same node-masking machinery reliability outages use (an offline
node is painted with an out-of-range owner id; scale-down only ever takes
*free* nodes, so a running job is never stranded).  The engine consumes
the materialized plan from the host through :func:`make_svc_ctx`, and
``service=None`` runs it without the subsystem.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

# The int32 "infinite time" sentinel, == repro_torch.core.jobs.INF_TIME
# (imported late to keep this module import-light; asserted equal at
# materialization).
INF_TIME = np.int32(2**30 - 1)

_DISTRIBUTIONS = ("fixed", "exponential")


@dataclasses.dataclass(frozen=True)
class ServiceClass:
    """One request class of an open-arrival mix.

    ``nodes`` is the per-request node footprint, ``mean_runtime`` the mean
    service duration under ``dist`` (``"fixed"`` — every request runs
    exactly ``mean_runtime`` — or ``"exponential"``), ``slo_wait`` the
    class's SLO: a request *meets* its SLO iff it starts within
    ``slo_wait`` seconds of arriving (the verdict is fixed at start time).
    ``weight`` is the class's share of the arrival mix.
    """

    name: str
    nodes: int = 1
    mean_runtime: int = 60
    dist: str = "fixed"
    slo_wait: int = 60
    weight: float = 1.0

    def __post_init__(self):
        if self.nodes < 1:
            raise ValueError(f"class {self.name!r}: nodes must be >= 1")
        if self.mean_runtime < 1:
            raise ValueError(f"class {self.name!r}: mean_runtime must be >= 1")
        if self.dist not in _DISTRIBUTIONS:
            raise ValueError(
                f"class {self.name!r}: unknown dist {self.dist!r}; "
                f"known: {_DISTRIBUTIONS}")
        if self.slo_wait < 0:
            raise ValueError(f"class {self.name!r}: slo_wait must be >= 0")
        if not self.weight > 0:
            raise ValueError(f"class {self.name!r}: weight must be positive")


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Queue-pressure hysteresis autoscaler (DESIGN.md §16).

    Every ``interval`` seconds (up to ``max_ticks`` ticks — the padded
    static capacity) the scaler reads the queued node demand (sum of node
    requests over WAITING jobs) and:

    - demand >= ``up_threshold``: bring up to ``step`` nodes back online
      (never beyond ``max_nodes``, which is capped at the machine size);
    - demand <= ``down_threshold``: take up to ``step`` *free* nodes
      offline (never below ``min_nodes``, and never a busy node — a
      running job is never stranded; drain happens by simply not
      re-adding capacity);
    - otherwise hold (hysteresis band).

    ``enabled=False`` keeps the padded tick shape but materializes every
    tick at ``INF_TIME`` — autoscale on/off points share one compiled
    executable.  ``max_nodes=None`` means the machine size.
    """

    up_threshold: int
    down_threshold: int
    min_nodes: int = 1
    max_nodes: Optional[int] = None
    step: int = 1
    interval: int = 60
    max_ticks: int = 256
    enabled: bool = True

    def __post_init__(self):
        if self.down_threshold < 0 or self.up_threshold <= self.down_threshold:
            raise ValueError(
                "hysteresis requires 0 <= down_threshold < up_threshold, "
                f"got down={self.down_threshold} up={self.up_threshold}")
        if self.min_nodes < 1:
            raise ValueError("min_nodes must be >= 1")
        if self.max_nodes is not None and self.max_nodes < self.min_nodes:
            raise ValueError("max_nodes must be >= min_nodes")
        if self.step < 1:
            raise ValueError("step must be >= 1")
        if self.interval < 1:
            raise ValueError("interval must be >= 1")
        if self.max_ticks < 0:
            raise ValueError("max_ticks must be >= 0")

    def static_key(self) -> tuple:
        """Only the padded tick capacity changes compiled shapes."""
        return ("autoscale", self.max_ticks)


@dataclasses.dataclass(frozen=True, eq=False)
class ServicePlan:
    """Materialized serving plan (host arrays; both engines consume this).

    ``submit``/``runtime``/``nodes``/``estimate`` are the *unpadded*
    request arrays in arrival order (submit already 0-based and
    non-decreasing, so ``make_jobset``'s (submit, id) sort is the identity
    permutation and the padded ``deadline``/``class_id`` columns stay
    row-aligned with the job table).  ``deadline[j] = submit[j] +
    slo_wait[class]``, ``INF_TIME`` in the padding slots.  ``tick_time``
    is the padded autoscaler tick stream (all ``INF_TIME`` when the
    scaler is disabled; shape ``[0]`` when the spec carries none).
    """

    submit: np.ndarray       # i32[n] arrival times, sorted, 0-based
    runtime: np.ndarray      # i32[n]
    nodes: np.ndarray        # i32[n]
    estimate: np.ndarray     # i32[n]
    deadline: np.ndarray     # i32[max_jobs], INF_TIME = padding
    class_id: np.ndarray     # i32[max_jobs], -1 = padding
    class_names: Tuple[str, ...]
    tick_time: np.ndarray    # i32[T], INF_TIME = padding/disabled
    up_threshold: int
    down_threshold: int
    step: int
    min_nodes: int
    max_nodes: Optional[int]  # None = machine size
    interval: int
    n_requests: int          # real (unpadded) request count
    truncated: bool = False  # arrival process generated > max_jobs requests

    @property
    def capacity(self) -> int:
        return int(self.deadline.shape[-1])

    def trace(self) -> Dict[str, np.ndarray]:
        return {"submit": self.submit, "runtime": self.runtime,
                "nodes": self.nodes, "estimate": self.estimate}


@dataclasses.dataclass(frozen=True)
class ServiceTrace:
    """Frozen open-arrival serving spec for a
    :class:`repro_torch.api.Scenario`.

    Poisson arrivals at ``rate`` requests/second over ``[0, horizon)``
    (or the explicit ``arrivals`` tuple of ``(time, class_index)`` pairs),
    classes drawn from the ``classes`` mix by weight.  ``max_jobs`` is the
    padded job capacity — requests past the horizon simply don't exist,
    and a draw that produces more than ``max_jobs`` requests truncates
    (loudly) to the earliest ones, so every rate point of a sweep shares
    one shape.  ``autoscale`` attaches the queue-pressure capacity stream
    (``None`` makes it a zero-length tick array).

    Everything except ``max_jobs`` and ``autoscale.max_ticks`` is ensemble
    *data*: rate / mix / SLO / seed / threshold sweeps share one bucket.
    """

    horizon: int
    rate: float = 0.1
    seed: int = 0
    classes: Tuple[ServiceClass, ...] = (ServiceClass("default"),)
    max_jobs: int = 1024
    arrivals: Optional[Tuple[Tuple[int, int], ...]] = None
    autoscale: Optional[AutoscalePolicy] = None

    def __post_init__(self):
        if not 0 < self.horizon < int(INF_TIME) // 2:
            raise ValueError(
                f"horizon must be in (0, {int(INF_TIME) // 2}) so arrival "
                "and deadline timestamps stay clear of the int32 sentinel")
        if self.arrivals is None and not self.rate > 0:
            raise ValueError(f"rate must be positive, got {self.rate}")
        if not self.classes:
            raise ValueError("at least one ServiceClass is required")
        if self.max_jobs < 1:
            raise ValueError("max_jobs must be >= 1")
        if self.arrivals is not None:
            times = [t for t, _ in self.arrivals]
            if any(t2 < t1 for t1, t2 in zip(times, times[1:])):
                raise ValueError("trace-driven arrivals must be sorted by time")
            if times and (times[0] < 0 or times[-1] >= self.horizon):
                raise ValueError("trace-driven arrival times must lie in "
                                 f"[0, {self.horizon})")
            for _, c in self.arrivals:
                if not 0 <= c < len(self.classes):
                    raise ValueError(f"arrival class index {c} out of range")
        if self.autoscale is not None and self.autoscale.enabled:
            biggest = max(c.nodes for c in self.classes)
            if biggest > self.autoscale.min_nodes:
                raise ValueError(
                    f"autoscale.min_nodes={self.autoscale.min_nodes} is "
                    f"smaller than the largest class footprint ({biggest} "
                    "nodes); a scaled-down cluster could never start such "
                    "a request (deadlock)")

    def static_key(self) -> tuple:
        """Compile-bucket contribution: the padded job capacity and the
        padded tick capacity are the only static shapes — rate / mix /
        SLO / seed / thresholds are ensemble data
        (``repro_torch.api.sweep``)."""
        return ("service", self.max_jobs,
                None if self.autoscale is None
                else self.autoscale.static_key())

    @property
    def pad_capacity(self) -> int:
        """Padded job-table capacity (``repro_torch.api.build_jobset`` pads every
        rate point to this one shape)."""
        return self.max_jobs

    @property
    def n_rows(self) -> int:
        return self.plan().n_requests

    def plan(self) -> ServicePlan:
        """The deterministic materialized plan (lru-cached per spec)."""
        return _materialize(self)

    def materialize(self) -> Dict[str, np.ndarray]:
        """Trace-spec interface: the job arrays for ``make_jobset``."""
        return self.plan().trace()


@functools.lru_cache(maxsize=256)
def _materialize(spec: ServiceTrace) -> ServicePlan:
    from repro_torch.core.jobs import INF_TIME as _engine_inf

    assert INF_TIME == _engine_inf, \
        "sentinel drifted from repro_torch.core.jobs"
    rng = np.random.default_rng(spec.seed)
    n_classes = len(spec.classes)

    if spec.arrivals is not None:
        times = np.asarray([t for t, _ in spec.arrivals], dtype=np.int64)
        cls = np.asarray([c for _, c in spec.arrivals], dtype=np.int64)
    else:
        # Poisson process: exponential gaps accumulated in float, floored to
        # integer seconds (simultaneous arrivals are legal ties); generation
        # stops at the horizon or at a loud truncation cap
        times_l = []
        t = 0.0
        limit = 4 * spec.max_jobs + 16
        while len(times_l) < limit:
            t += rng.exponential(1.0 / spec.rate)
            if t >= spec.horizon:
                break
            times_l.append(int(t))
        times = np.asarray(times_l, dtype=np.int64)
        w = np.asarray([c.weight for c in spec.classes], dtype=np.float64)
        cls = rng.choice(n_classes, size=len(times), p=w / w.sum())

    truncated = len(times) > spec.max_jobs
    if truncated:
        import warnings

        warnings.warn(
            f"ServiceTrace(rate={spec.rate}, horizon={spec.horizon}) "
            f"generated {len(times)} requests but max_jobs={spec.max_jobs}; "
            f"keeping only the earliest {spec.max_jobs} — raise max_jobs "
            "(or lower rate/horizon) unless early-window truncation is "
            "intended", stacklevel=3)
        times, cls = times[:spec.max_jobs], cls[:spec.max_jobs]

    n = len(times)
    times = times - (times.min() if n else 0)   # make_jobset's shift a no-op
    c_nodes = np.asarray([c.nodes for c in spec.classes], dtype=np.int64)
    c_mean = np.asarray([c.mean_runtime for c in spec.classes], dtype=np.int64)
    c_slo = np.asarray([c.slo_wait for c in spec.classes], dtype=np.int64)
    fixed = np.asarray([c.dist == "fixed" for c in spec.classes], dtype=bool)
    # one rng draw per request regardless of dist, so the class mix never
    # perturbs the arrival stream of other requests
    u = rng.random(n)
    drawn = np.ceil(-c_mean[cls] * np.log1p(-u)).astype(np.int64)
    runtime = np.where(fixed[cls], c_mean[cls], np.maximum(drawn, 1))
    nodes = c_nodes[cls]
    estimate = np.maximum(c_mean[cls], runtime)   # walltime request >= actual

    top = int(times.max(initial=0)) + 2 * int(estimate.max(initial=1)) \
        + int(c_slo.max(initial=0))
    if top >= int(INF_TIME):
        raise ValueError(
            f"ServiceTrace horizon overflows the int32 clock: max arrival "
            f"{int(times.max(initial=0))} + runtimes/SLOs reaches {top} >= "
            f"{int(INF_TIME)}; rescale horizon or mean_runtime")

    J = spec.max_jobs
    deadline = np.full((J,), INF_TIME, dtype=np.int32)
    class_id = np.full((J,), -1, dtype=np.int32)
    deadline[:n] = (times + c_slo[cls]).astype(np.int32)
    class_id[:n] = cls.astype(np.int32)

    auto = spec.autoscale
    if auto is None:
        tick_time = np.zeros((0,), dtype=np.int32)
        up_t, down_t, step, min_n, max_n, interval = 0, 0, 1, 1, None, 1
    else:
        T = auto.max_ticks
        tick_time = np.full((T,), INF_TIME, dtype=np.int32)
        if auto.enabled:
            ticks = (np.arange(1, T + 1, dtype=np.int64) * auto.interval)
            ticks = np.minimum(ticks, int(INF_TIME))
            tick_time[:] = ticks.astype(np.int32)
        up_t, down_t = auto.up_threshold, auto.down_threshold
        step, min_n = auto.step, auto.min_nodes
        max_n, interval = auto.max_nodes, auto.interval

    return ServicePlan(
        submit=times.astype(np.int32), runtime=runtime.astype(np.int32),
        nodes=nodes.astype(np.int32), estimate=estimate.astype(np.int32),
        deadline=deadline, class_id=class_id,
        class_names=tuple(c.name for c in spec.classes),
        tick_time=tick_time, up_threshold=int(up_t),
        down_threshold=int(down_t), step=int(step), min_nodes=int(min_n),
        max_nodes=None if max_n is None else int(max_n),
        interval=int(interval), n_requests=n, truncated=truncated,
    )


class SvcCtx(NamedTuple):
    """A run's service plan as the engine consumes it (host values): the
    padded ``deadline`` column (i32[max_jobs]), the autoscaler's
    ``tick_time`` stream (i32[T], ``[0]`` without an autoscaler) and its
    thresholds, with ``max_nodes`` clamped to the machine."""

    deadline: np.ndarray
    tick_time: np.ndarray
    up_threshold: int
    down_threshold: int
    step: int
    min_nodes: int
    max_nodes: int


def make_svc_ctx(service, *, n_nodes: Optional[int] = None
                 ) -> Optional[SvcCtx]:
    """Canonicalize a ``service`` argument into the engine's
    :class:`SvcCtx`, or ``None``.

    Accepts ``None`` (the engine runs without the subsystem), a
    :class:`ServiceTrace` (its plan), a :class:`ServicePlan`, the
    reference's 7-tuple ``(deadline, tick_time, up_threshold,
    down_threshold, step, min_nodes, max_nodes)`` or a ``SvcCtx``.
    ``max_nodes`` (``None``: the machine) is clamped to ``n_nodes``, the
    cluster size, as the reference's engine clamps it.
    """
    if service is None:
        return None
    if isinstance(service, ServiceTrace):
        service = service.plan()
    if isinstance(service, ServicePlan):
        max_n = service.max_nodes
        service = (service.deadline, service.tick_time,
                   service.up_threshold, service.down_threshold,
                   service.step, service.min_nodes,
                   int(INF_TIME) if max_n is None else max_n)
    if not (isinstance(service, tuple) and len(service) == 7):
        raise TypeError(
            "service must be None, a ServiceTrace, a ServicePlan, or a "
            f"7-tuple svc ctx; got {type(service).__name__}")
    deadline, tick_time, up_t, down_t, step, min_n, max_n = service
    max_n = int(max_n)
    if n_nodes is not None:
        max_n = min(max_n, int(n_nodes))
    return SvcCtx(np.asarray(deadline, dtype=np.int32),
                  np.asarray(tick_time, dtype=np.int32), int(up_t),
                  int(down_t), int(step), int(min_n), max_n)
