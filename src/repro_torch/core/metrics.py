"""Offline metrics of a run (paper Figs. 3 and 4b, DESIGN.md §11.5).

The PyTorch port's own copy of ``percentiles``, ``summary`` and the step
series (occupancy, active jobs, queue length, sampling onto a grid), and of
the allocation series (fragmentation, largest free block, job span),
``alloc_summary``, ``reliability_summary`` and ``slo_summary``, from
``repro.core.metrics``: pure numpy functions of the
canonical result dict, identical to the reference's, so both engines'
metrics agree bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def percentiles(values, qs, mask=None):
    """Exact linear-interpolation percentiles over (optionally masked)
    job columns, numerically identical to ``numpy.percentile`` (the same
    ``(q/100)·(n-1)`` position with the lerp evaluated from the nearer
    endpoint).  ``qs`` may be a scalar (returns ``float``) or a sequence
    (returns ``float64[len(qs)]``); an empty selection returns NaN."""
    scalar = np.ndim(qs) == 0
    values = np.asarray(values, dtype=np.float64).ravel()
    if mask is not None:
        values = values[np.asarray(mask, dtype=bool).ravel()]
    qs_arr = np.atleast_1d(np.asarray(qs, dtype=np.float64))
    if np.any((qs_arr < 0) | (qs_arr > 100)):
        raise ValueError(f"percentiles must lie in [0, 100]; got {qs!r}")
    if values.size == 0:
        out = np.full(qs_arr.shape, np.nan)
    else:
        s = np.sort(values)
        pos = qs_arr / 100.0 * (s.size - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, s.size - 1)
        t = pos - lo
        d = s[hi] - s[lo]
        out = np.where(t >= 0.5, s[hi] - d * (1.0 - t), s[lo] + d * t)
    return float(out[0]) if scalar else out


def _select_valid(res: Dict[str, np.ndarray]):
    v = np.asarray(res["valid"], dtype=bool) & np.asarray(res["done"], dtype=bool)
    return (
        np.asarray(res["submit"])[v],
        np.asarray(res["start"])[v],
        np.asarray(res["finish"])[v],
        np.asarray(res["nodes"])[v],
        np.asarray(res["runtime"])[v],
        np.asarray(res["ready"])[v],
    )


def summary(res, total_nodes: int) -> Dict[str, float]:
    """Scalar metrics of the policy comparison (paper Fig. 4b), over the
    valid jobs that finished; wait = start - ready."""
    submit, start, finish, nodes, runtime, ready = _select_valid(res)
    if len(submit) == 0:
        return {k: 0.0 for k in (
            "n_jobs", "avg_wait", "p50_wait", "p95_wait", "max_wait",
            "avg_bounded_slowdown", "makespan", "utilization", "throughput")}
    wait = (start - ready).astype(np.float64)
    run = runtime.astype(np.float64)
    bsld = np.maximum((wait + run) / np.maximum(run, 10.0), 1.0)
    makespan = float(finish.max() - submit.min())
    node_seconds = float((nodes.astype(np.float64) * run).sum())
    util = node_seconds / (total_nodes * makespan) if makespan > 0 else 0.0
    return {
        "n_jobs": float(len(submit)),
        "avg_wait": float(wait.mean()),
        "p50_wait": percentiles(wait, 50),
        "p95_wait": percentiles(wait, 95),
        "max_wait": float(wait.max()),
        "avg_bounded_slowdown": float(bsld.mean()),
        "makespan": makespan,
        "utilization": util,
        "throughput": float(len(submit)) / makespan if makespan > 0 else 0.0,
    }


def step_series(times: np.ndarray, deltas: np.ndarray):
    """Event-sorted cumulative step function: returns (t, value_after_t)."""
    order = np.argsort(times, kind="stable")
    t = times[order]
    v = np.cumsum(deltas[order])
    # collapse duplicate timestamps to the final value at that time
    keep = np.r_[t[1:] != t[:-1], True]
    return t[keep], v[keep]


def occupancy_series(res) -> tuple[np.ndarray, np.ndarray]:
    """Nodes in use over time (paper Fig. 3a)."""
    _, start, finish, nodes, _, _ = _select_valid(res)
    times = np.r_[start, finish]
    deltas = np.r_[nodes, -nodes].astype(np.int64)
    return step_series(times, deltas)


def active_jobs_series(res) -> tuple[np.ndarray, np.ndarray]:
    """Number of running jobs over time (paper Fig. 3b)."""
    _, start, finish, _, _, _ = _select_valid(res)
    times = np.r_[start, finish]
    deltas = np.r_[np.ones_like(start), -np.ones_like(finish)].astype(np.int64)
    return step_series(times, deltas)


def queue_length_series(res) -> tuple[np.ndarray, np.ndarray]:
    """Waiting-queue length over time."""
    submit, start, _, _, _, _ = _select_valid(res)
    times = np.r_[submit, start]
    deltas = np.r_[np.ones_like(submit), -np.ones_like(start)].astype(np.int64)
    return step_series(times, deltas)


def sample_series(t: np.ndarray, v: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Sample a step series onto a regular grid (for plotting/comparison)."""
    idx = np.searchsorted(t, grid, side="right") - 1
    out = np.where(idx >= 0, v[np.clip(idx, 0, len(v) - 1)], 0)
    return out.astype(np.float64)


def fragmentation_series(res) -> tuple[np.ndarray, np.ndarray]:
    """Fragmentation over time from the engine's per-event log
    (DESIGN.md §11.5): ``1 - largest_free_block / free_nodes``, 0 when all
    free capacity is one contiguous block.  Needs a result of a run with a
    machine."""
    t, lfb, freen = _event_log(res)
    with np.errstate(divide="ignore", invalid="ignore"):
        frag = np.where(freen > 0, 1.0 - lfb / np.maximum(freen, 1), 0.0)
    return t, frag


def largest_free_block_series(res) -> tuple[np.ndarray, np.ndarray]:
    """Largest free contiguous block over time (allocation results only)."""
    t, lfb, _ = _event_log(res)
    return t, lfb.astype(np.float64)


def _event_log(res):
    if "ev_time" not in res:
        raise ValueError(
            "result has no event log; run simulate with a Machine "
            "(see repro_torch.alloc)")
    t = np.asarray(res["ev_time"], dtype=np.int64)
    lfb = np.asarray(res["ev_lfb"], dtype=np.int64)
    freen = np.asarray(res["ev_free"], dtype=np.int64)
    used = t >= 0
    t, lfb, freen = t[used], lfb[used], freen[used]
    # collapse duplicate timestamps to the final row at that time
    keep = np.r_[t[1:] != t[:-1], True] if len(t) else np.zeros(0, bool)
    return t[keep], lfb[keep], freen[keep]


def job_span_series(res) -> tuple[np.ndarray, np.ndarray]:
    """Mean topology-group span of *running* jobs over time (allocation
    results only).  NaN while nothing runs."""
    v = np.asarray(res["valid"], bool) & np.asarray(res["done"], bool)
    start = np.asarray(res["start"])[v]
    finish = np.asarray(res["finish"])[v]
    span = np.asarray(res["alloc_span"])[v].astype(np.int64)
    if len(start) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    times = np.r_[start, finish]
    t, tot = step_series(times, np.r_[span, -span])
    _, cnt = step_series(times, np.r_[np.ones_like(start),
                                      -np.ones_like(finish)].astype(np.int64))
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = np.where(cnt > 0, tot / np.maximum(cnt, 1), np.nan)
    return t, mean


def alloc_summary(res) -> Dict[str, float]:
    """Scalar locality and fragmentation metrics (allocation results
    only)."""
    v = np.asarray(res["valid"], bool) & np.asarray(res["done"], bool)
    span = np.asarray(res["alloc_span"])[v].astype(np.float64)
    t, frag = fragmentation_series(res)
    _, lfb, freen = _event_log(res)
    busy = freen < freen.max(initial=0) if len(freen) else np.zeros(0, bool)
    return {
        "mean_job_span": float(span.mean()) if len(span) else 0.0,
        "max_job_span": float(span.max()) if len(span) else 0.0,
        "mean_frag": float(frag[busy].mean()) if busy.any() else 0.0,
        "min_largest_free_block": float(lfb.min()) if len(lfb) else 0.0,
    }


def reliability_summary(res) -> Dict[str, float]:
    """Scalar reliability metrics (results carrying failure columns,
    DESIGN.md §15).

    ``goodput`` is the fraction of consumed node-seconds that produced
    completed work: useful / (useful + lost), where *useful* counts
    completed (non-aborted) jobs' runtimes and *lost* counts every
    node-second of checkpoint rework, restart overhead, and aborted
    partial work the failure model charged.

    Unit caveat: with a contention model active, *lost* accrues in
    dilated wall-clock units (elapsed time of a dilated run) while
    *useful* counts nominal runtimes, biasing goodput low by up to the
    dilation factor — compare goodput across contention settings with
    care, or run reliability studies with contention off.
    """
    valid = np.asarray(res["valid"], dtype=bool)
    done = valid & np.asarray(res["done"], dtype=bool)
    nodes = np.asarray(res["nodes"], dtype=np.float64)
    runtime = np.asarray(res["runtime"], dtype=np.float64)
    lost = np.asarray(res["lost_work"], dtype=np.float64)
    useful_ns = float((nodes * runtime)[done].sum())
    lost_ns = float((nodes * lost)[valid].sum())
    denom = useful_ns + lost_ns
    return {
        "total_restarts": float(np.asarray(res["n_restarts"])[valid].sum()),
        "n_aborted": float(np.asarray(res["aborted"])[valid].sum()),
        "lost_node_s": lost_ns,
        "goodput": useful_ns / denom if denom > 0 else 1.0,
    }


def slo_summary(res, class_names=None, total_nodes=None) -> Dict[str, float]:
    """Scalar serving metrics (results carrying SLO columns, DESIGN.md §16).

    - ``slo_attainment`` / ``deadline_miss_rate``: fraction of completed
      requests that started by / after their deadline (the verdict both
      engines fix at start time);
    - ``p50_wait`` / ``p99_wait``: exact wait percentiles over completed
      requests (and ``{class}_p50_wait`` / ``{class}_p99_wait`` /
      ``{class}_miss_rate`` per class when ``class_names`` is given);
    - ``slo_goodput``: SLO-met node-seconds over the *provisioned capacity
      integral* — under autoscaling the capacity level steps through the
      consumed tick stream (``cap_time``/``cap_online``), so scaling down
      idle capacity raises goodput even at equal attainment.  Requires
      ``total_nodes`` (the level before the first tick); omitted when
      unavailable or when the makespan is empty.
    """
    valid = np.asarray(res["valid"], dtype=bool)
    done = valid & np.asarray(res["done"], dtype=bool)
    met = np.asarray(res["slo_met"], dtype=bool)
    wait = np.asarray(res["wait"], dtype=np.float64)
    n_done = int(done.sum())
    attain = float(met[done].sum()) / n_done if n_done else 1.0
    out = {
        "n_requests": float(valid.sum()),
        "slo_attainment": attain,
        "deadline_miss_rate": 1.0 - attain,
        "p50_wait": percentiles(wait, 50, mask=done),
        "p99_wait": percentiles(wait, 99, mask=done),
    }
    if class_names is not None and "class_id" in res:
        cid = np.asarray(res["class_id"], dtype=np.int64)
        for c, name in enumerate(class_names):
            sel = done & (cid == c)
            k = int(sel.sum())
            out[f"{name}_p50_wait"] = percentiles(wait, 50, mask=sel)
            out[f"{name}_p99_wait"] = percentiles(wait, 99, mask=sel)
            out[f"{name}_miss_rate"] = (
                float((~met[sel]).sum()) / k if k else 0.0)
    if total_nodes is not None and n_done:
        nodes = np.asarray(res["nodes"], dtype=np.float64)
        start = np.asarray(res["start"], dtype=np.float64)
        finish = np.asarray(res["finish"], dtype=np.float64)
        useful = float((nodes * (finish - start))[done & met].sum())
        makespan = float(finish[done].max())
        # capacity integral: total_nodes until the first consumed tick,
        # then the logged online level between ticks, clipped to makespan
        t = np.asarray(res.get("cap_time", ()), dtype=np.float64)
        lvl = np.asarray(res.get("cap_online", ()), dtype=np.float64)
        edges = np.clip(np.r_[0.0, t, makespan], 0.0, makespan)
        levels = np.r_[float(total_nodes), lvl]
        cap_int = float((np.maximum(np.diff(edges), 0.0) * levels).sum())
        if cap_int > 0:
            out["slo_goodput"] = useful / cap_int
    return out
