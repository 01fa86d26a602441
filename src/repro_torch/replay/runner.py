"""Streaming, crash-safe replay of full-archive traces (DESIGN.md §19).

Counterpart of ``repro.replay.runner``.  A full Parallel Workloads Archive
log (10^5-10^6 jobs, month-long horizons) cannot go through one-shot
``simulate``: its table scales with the whole trace and the int32 clock
caps the horizon.  :class:`StreamingReplay` drives the trace through
bounded **windows** instead: the device holds only the next W jobs not yet
finished, each round runs ``engine.simulate_window`` up to the next
unadmitted arrival, finished rows are harvested to int64 host columns,
and the freed slots are refilled from the trace cursor.  Clocks are
rebased every round: the host keeps absolute int64 time, the device sees
int32 offsets from the round's base ``t0``, so horizons far beyond int32
never overflow.

Windowing is exact: live rows stay compacted in global (submit, id)
order, so every tie-break of the engine (FCFS and SJF selection,
backfill's shadow walk, the blocking order, the failure victim's cumsum)
matches the one-shot run's, and a round never processes an event at or
past the first unadmitted submit, so the engine never schedules against a
partial arrival set.  A replay equals the one-shot ``simulate`` and the
host oracle's ``refsim.replay_reference`` bit for bit.

A round uploads its table and state in one copy (the live rows'
int64 host columns rebased to int32, ``INF64`` to ``INF_TIME``), with a
last row that is PENDING and never arrives while the trace has more jobs,
so that the window's unfinished count stays open; it builds the failure
stream's context and the reliability state from the host's arrays, runs
the window with no event log, and reads the rows back in one copy.

Crash safety (the degradation ladder, loud then soft):

- every ``ckpt_every``-th round the carried state (live rows, harvested
  results, cursor, clocks, flags) lands in ``repro_torch.ckpt`` (atomic
  rename and crc32); :func:`resume` restarts from the last durable round
  and equals an uninterrupted run, and refuses a checkpoint of another
  configuration;
- event-cap **saturation** shows as the window's ``saturated`` flag; the
  truncated round is a valid prefix, so the runner counts it, doubles the
  cap and goes on;
- **window overflow** (more than W jobs alive at once) shows as a round
  with no progress and no free slot; the window doubles (at most
  ``max_window_doublings`` times) before the runner gives up;
- **clock-rebase overflow** (a window-relative time that does not fit
  int32) is counted, retried once with a doubled window, then raises.

All three land as counters on ``ReplayResult.flags``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.alloc import Contention
from repro_torch.ckpt.store import load_checkpoint_raw, save_checkpoint
from repro_torch.core.engine import make_alloc_ctx, simulate_window
from repro_torch.core.jobs import (
    DONE, INF_TIME, PENDING, POLICY_IDS, JobSet, RelState, SimState,
    resolve_device,
)
from repro_torch.reliability.model import FailCtx, merge_stream
from repro_torch.traces.normalize import normalize_trace

# the host's "infinite"/unset sentinel for absolute int64 times; it maps to
# the engine's int32 INF_TIME at upload and back at download
INF64 = np.int64(1) << 62

_I32_MIN = -(2 ** 31) + 1


class ReplayError(RuntimeError):
    """The degradation ladder ran out of retries."""


class ReplayInterrupted(RuntimeError):
    """Raised by the crash hook after a durable round."""


class _RebaseOverflow(Exception):
    pass


@dataclasses.dataclass
class ReplayFlags:
    """Counters of the degraded conditions (DESIGN.md §19 ladder)."""

    saturated_rounds: int = 0    # rounds that hit the event cap
    cap_doublings: int = 0
    window_doublings: int = 0    # more than W live jobs forced a doubling
    rebase_overflows: int = 0    # a window-relative time overflowed int32

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ReplayFlags":
        return cls(**{f.name: int(d.get(f.name, 0))
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class ReplayResult:
    """Per-job columns in global (submit, id) order, absolute int64 times
    on the trace's rebased epoch (min submit 0): the one-shot
    ``SimResult``'s and the oracle's schema, so the three compare
    directly."""

    submit: np.ndarray       # i64[N]
    runtime: np.ndarray      # i64[N]
    estimate: np.ndarray     # i64[N]
    nodes: np.ndarray        # i64[N]
    priority: np.ndarray     # i64[N]
    start: np.ndarray        # i64[N] (-1 if never started, as the oracle)
    finish: np.ndarray       # i64[N] (-1 if never finished)
    wait: np.ndarray         # i64[N] start - submit (traces carry no deps)
    done: np.ndarray         # bool[N] completed (aborted jobs are not)
    alloc_first: np.ndarray  # i64[N] on a machine (-1 otherwise)
    alloc_span: np.ndarray   # i64[N]
    alloc_sum: np.ndarray    # i64[N]
    n_restarts: np.ndarray   # i64[N] with failures (0 otherwise)
    lost_work: np.ndarray    # i64[N]
    aborted: np.ndarray      # bool[N]
    makespan: int
    n_events: int
    n_rounds: int
    peak_live: int           # peak window occupancy (<= final window)
    window: int              # final window size after any doublings
    flags: ReplayFlags

    @property
    def n_jobs(self) -> int:
        return int(self.submit.shape[0])

    def summary(self) -> dict:
        """Wait and node-usage summaries (the paper's accuracy metrics)."""
        w = self.wait[self.done]
        node_s = (self.nodes * (self.finish - self.start))[self.done]
        return {
            "n_jobs": self.n_jobs,
            "n_done": int(self.done.sum()),
            "n_aborted": int(self.aborted.sum()),
            "makespan": int(self.makespan),
            "n_events": int(self.n_events),
            "n_rounds": int(self.n_rounds),
            "peak_live": int(self.peak_live),
            "window": int(self.window),
            "mean_wait": float(w.mean()) if w.size else 0.0,
            "p50_wait": float(np.percentile(w, 50)) if w.size else 0.0,
            "p95_wait": float(np.percentile(w, 95)) if w.size else 0.0,
            "max_wait": int(w.max()) if w.size else 0,
            "node_seconds": int(node_s.sum()),
            "flags": self.flags.as_dict(),
        }


def _trace_crc(t: dict) -> int:
    crc = 0
    for key in ("submit", "runtime", "estimate", "nodes", "priority"):
        crc = zlib.crc32(np.ascontiguousarray(t[key]).tobytes(), crc)
    return crc


# live-row columns carried between rounds (absolute int64 host values)
_LIVE_TIME = ("start", "finish", "rsv")            # INF64-sentinel times
_LIVE_PLAIN = ("g", "submit", "runtime", "estimate", "nodes", "priority",
               "jstate", "remaining", "alloc_first", "alloc_span",
               "alloc_sum")
_LIVE_REL = ("last_start", "n_restarts", "lost_work", "aborted")
# the rows of a round's upload, in order: the table's, then the state's
_JOB_ROWS = ("submit", "runtime", "estimate", "nodes", "priority")
_STATE_ROWS = ("jstate", "start", "finish", "rsv_finish", "remaining",
               "alloc_first", "alloc_span", "alloc_sum")
_REL_ROWS = ("last_start", "n_restarts", "lost_work")


class StreamingReplay:
    """Windowed trace replay with durable per-round checkpoints.

    Most callers want :func:`replay_trace` or :func:`resume`; the class is
    the stateful core they wrap.  ``failures`` must be a materialized
    ``repro_torch.reliability.FailureTrace`` (the engine and the oracle
    consume the same arrays).  ``machine`` is a ``repro_torch.alloc.
    Machine`` (scalar-counter mode when ``None``).  ``device=None`` runs
    on ``cuda`` (and raises without one).
    """

    def __init__(self, trace, policy="fcfs", *, total_nodes: int,
                 window: int = 4096, machine=None, alloc=None,
                 contention=None, failures=None,
                 max_events: Optional[int] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 1,
                 keep: int = 3, max_window_doublings: int = 6,
                 device=None, _crash_after_round: Optional[int] = None):
        if isinstance(trace, str):
            from repro_torch.traces.swf import load_swf
            trace, _ = load_swf(trace)
        self.device = resolve_device(device)
        self.total_nodes = int(total_nodes)
        self.policy_id = (POLICY_IDS[policy] if isinstance(policy, str)
                          else int(policy))
        if machine is not None and machine.n_nodes != self.total_nodes:
            raise ValueError(
                f"machine has {machine.n_nodes} nodes but "
                f"total_nodes={self.total_nodes}")
        self.machine = machine
        self.ctx = (None if machine is None else make_alloc_ctx(
            machine.to(self.device), alloc, contention))
        self.t = normalize_trace(trace, self.total_nodes)
        self.n_jobs = int(self.t["submit"].shape[0])
        self.trace_crc = _trace_crc(self.t)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = max(1, int(ckpt_every))
        self.keep = int(keep)
        self.max_window_doublings = int(max_window_doublings)
        self._crash_after_round = _crash_after_round

        # the failure stream, merged on the host as both engines merge it
        self.has_rel = failures is not None
        self.stream_time = self._rel_const = None
        if failures is not None:
            tt, nn, kk = merge_stream(failures)
            self.stream_time = tt.astype(np.int64)
            self._rel_const = (nn.astype(np.int32), kk.astype(np.int32),
                               int(failures.requeue),
                               int(failures.checkpoint_interval),
                               int(failures.restart_overhead))

        # the clock-rebase margin: the farthest an event of a round can
        # land past its base is one (contention-dilated) dispatch plus the
        # restart overhead; admissions and t_hi stay below ``limit``, so
        # every int32 addition of the engine stays inside int32
        maxdur = int(max(self.t["runtime"].max(initial=1),
                         self.t["estimate"].max(initial=1)))
        dil = maxdur
        if contention is not None:
            con = Contention.canonical(contention)
            num, den = int(con.alpha_num), int(con.alpha_den)
            dil = maxdur + maxdur * num * max(self.total_nodes - 1, 1) // den
        overhead = (int(failures.restart_overhead) if failures is not None
                    else 0)
        margin = 2 * (dil + overhead + 1)
        if margin >= int(INF_TIME) // 2:
            raise ReplayError(
                f"job durations too large for int32 windows (margin "
                f"{margin} >= {int(INF_TIME) // 2}); rescale the trace")
        self.limit = int(INF_TIME) - margin

        # loop state (overwritten by _restore on resume)
        self.window = int(window)
        self.cap = (self._default_cap(self.window) if max_events is None
                    else int(max_events))
        self._cap_fixed = max_events is not None
        self.cursor = 0
        self.clock = 0                      # absolute int64 host clock
        self.free = self.total_nodes
        self.rel_ptr = 0
        self.n_events = 0
        self.round = 0
        self.n_rounds = 0
        self.peak_live = 0
        self.flags = ReplayFlags()
        self.live = self._empty_live()
        N = machine.n_nodes if machine is not None else 0
        self.owner_g = np.full(N, -1, dtype=np.int64)
        self.down = np.zeros(N, dtype=bool)
        self.results = {
            "start": np.full(self.n_jobs, INF64, dtype=np.int64),
            "finish": np.full(self.n_jobs, INF64, dtype=np.int64),
            "done": np.zeros(self.n_jobs, dtype=bool),
            "alloc_first": np.full(self.n_jobs, -1, dtype=np.int64),
            "alloc_span": np.zeros(self.n_jobs, dtype=np.int64),
            "alloc_sum": np.zeros(self.n_jobs, dtype=np.int64),
            "n_restarts": np.zeros(self.n_jobs, dtype=np.int64),
            "lost_work": np.zeros(self.n_jobs, dtype=np.int64),
            "aborted": np.zeros(self.n_jobs, dtype=bool),
        }

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _default_cap(self, window: int) -> int:
        K = 0 if self.stream_time is None else int(self.stream_time.shape[0])
        return 6 * (window + 1) + 2 * K + 16

    def _empty_live(self) -> dict:
        live = {k: np.zeros(0, dtype=np.int64) for k in _LIVE_PLAIN}
        live.update({k: np.zeros(0, dtype=np.int64) for k in _LIVE_TIME})
        if self.has_rel:
            live.update({k: np.zeros(0, dtype=np.int64) for k in _LIVE_REL})
            live["aborted"] = np.zeros(0, dtype=bool)
        return live

    # ------------------------------------------------------------------
    # int64 <-> window-relative int32 rebasing
    # ------------------------------------------------------------------

    @staticmethod
    def _rel32(abs64: np.ndarray, t0: int) -> np.ndarray:
        out = abs64 - t0
        sent = abs64 >= INF64
        if ((~sent) & ((out <= _I32_MIN) | (out >= int(INF_TIME)))).any():
            raise _RebaseOverflow()
        return np.where(sent, np.int64(INF_TIME), out).astype(np.int32)

    @staticmethod
    def _abs64(rel32: np.ndarray, t0: int) -> np.ndarray:
        r = rel32.astype(np.int64)
        return np.where(r >= np.int64(INF_TIME), INF64, r + t0)

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------

    def _harvest(self) -> None:
        live = self.live
        done = np.asarray(live["jstate"]) == DONE
        if done.any():
            g = live["g"][done]
            r = self.results
            for k in ("start", "finish", "alloc_first", "alloc_span",
                      "alloc_sum"):
                r[k][g] = live[k][done]
            if self.has_rel:
                for k in ("n_restarts", "lost_work", "aborted"):
                    r[k][g] = live[k][done]
                r["done"][g] = ~live["aborted"][done].astype(bool)
            else:
                r["done"][g] = True
            self.live = {k: v[~done] for k, v in live.items()}

    def _admit(self, t0: int) -> int:
        n_free = self.window - len(self.live["g"])
        k = min(n_free, self.n_jobs - self.cursor)
        if k <= 0:
            return 0
        # only jobs whose window-relative submit stays under the limit;
        # submits are sorted, so this is a prefix
        hi = np.searchsorted(self.t["submit"][self.cursor:self.cursor + k],
                             np.int64(t0 + self.limit), side="right")
        k = int(min(k, hi))
        if k <= 0:
            return 0
        sl = slice(self.cursor, self.cursor + k)
        add = {
            "g": np.arange(self.cursor, self.cursor + k, dtype=np.int64),
            "jstate": np.full(k, PENDING, dtype=np.int64),
            "remaining": self.t["runtime"][sl].copy(),
            "start": np.full(k, INF64, dtype=np.int64),
            "finish": np.full(k, INF64, dtype=np.int64),
            "rsv": np.full(k, INF64, dtype=np.int64),
            "alloc_first": np.full(k, -1, dtype=np.int64),
            "alloc_span": np.zeros(k, dtype=np.int64),
            "alloc_sum": np.zeros(k, dtype=np.int64),
        }
        for c in _JOB_ROWS:
            add[c] = self.t[c][sl].copy()
        if self.has_rel:
            add["last_start"] = np.full(k, t0, dtype=np.int64)
            add["n_restarts"] = np.zeros(k, dtype=np.int64)
            add["lost_work"] = np.zeros(k, dtype=np.int64)
            add["aborted"] = np.zeros(k, dtype=bool)
        self.live = {key: np.concatenate([self.live[key], add[key]])
                     for key in self.live}
        self.cursor += k
        return k

    def _window_args(self, t0: int) -> tuple:
        """The round's table and state on the device: the live rows
        compacted in rows ``[0, n)`` in ascending global order (the
        invariant every tie-break relies on), invalid DONE padding, and a
        last row that is PENDING with submit ``INF_TIME`` while the trace
        has unadmitted jobs (it never arrives, and keeps the window's
        unfinished count open; in the drain the window is the whole
        remaining table, so the count must close as in a one-shot run).
        One upload for the table and the per-job state."""
        live = self.live
        n = len(live["g"])
        W1 = self.window + 1

        def pad(a, fill):
            out = np.full(W1, fill, dtype=np.int32)
            out[:n] = a
            return out

        jstate = pad(live["jstate"], DONE)
        if self.cursor < self.n_jobs:
            jstate[W1 - 1] = PENDING
        rows = [pad(self._rel32(live["submit"], t0), INF_TIME),
                pad(live["runtime"], 1), pad(live["estimate"], 1),
                pad(live["nodes"], 1), pad(live["priority"], 0), jstate,
                pad(self._rel32(live["start"], t0), INF_TIME),
                pad(self._rel32(live["finish"], t0), INF_TIME),
                pad(self._rel32(live["rsv"], t0), INF_TIME),
                pad(live["remaining"], 1), pad(live["alloc_first"], -1),
                pad(live["alloc_span"], 0), pad(live["alloc_sum"], 0)]
        if self.has_rel:
            rows += [pad(self._rel32(live["last_start"], t0), 0),
                     pad(live["n_restarts"], 0), pad(live["lost_work"], 0)]
        valid = np.zeros(W1, dtype=bool)
        valid[:n] = True
        flags = np.zeros((2, W1), dtype=bool)
        flags[0, :n] = True
        if self.has_rel:
            flags[1, :n] = live["aborted"]
        dev = self.device
        block = torch.from_numpy(np.stack(rows)).to(dev)
        flags = torch.from_numpy(flags).to(dev)
        row = dict(zip(_JOB_ROWS + _STATE_ROWS + _REL_ROWS, block))
        jobs = JobSet(valid=flags[0], **{c: row[c] for c in _JOB_ROWS})
        N = self.machine.n_nodes if self.machine is not None else 0
        owner = np.full(N, -1, dtype=np.int32)
        held = self.owner_g >= 0
        if held.any():
            owner[held] = np.searchsorted(live["g"], self.owner_g[held])
        rel = None
        if self.has_rel:
            rel = RelState(ctx=[], ptr=[self.rel_ptr],
                           last_start=row["last_start"],
                           n_restarts=row["n_restarts"],
                           lost_work=row["lost_work"], aborted=flags[1],
                           down=torch.from_numpy(self.down).to(dev),
                           down_host=self.down.copy())
        state = SimState(
            clock=int(self.clock - t0), jstate=row["jstate"],
            start=row["start"], finish=row["finish"],
            rsv_finish=row["rsv_finish"], remaining=row["remaining"],
            free=self.free, n_events=0,
            node_owner=torch.from_numpy(owner).to(dev),
            alloc=block[len(_JOB_ROWS) + 5:len(_JOB_ROWS) + 8],
            # no event log: replay never reads one
            ev_time=np.zeros(0, dtype=np.int32),
            ev_free=np.zeros(0, dtype=np.int32),
            ev_lfb=torch.zeros(0, dtype=torch.int32, device=dev),
            rel=rel)
        return jobs, state

    def _stream(self, t0: int) -> Optional[FailCtx]:
        """The failure stream with its times rebased to the round's base."""
        if not self.has_rel:
            return None
        times = np.clip(self.stream_time - t0, np.int64(_I32_MIN),
                        np.int64(INF_TIME)).astype(np.int32)
        return FailCtx(times, *self._rel_const)

    def _run_round(self, t0: int, t_hi_rel: int) -> tuple:
        """One window; returns ``(events processed, saturated)``."""
        jobs, state = self._window_args(t0)
        state, sat = simulate_window(self.policy_id, jobs, state, t_hi_rel,
                                     min(self.cap, int(INF_TIME)), self.ctx,
                                     rel=self._stream(t0))
        n = len(self.live["g"])
        cols = [state.jstate, state.start, state.finish, state.rsv_finish,
                state.remaining, *state.alloc]
        if self.has_rel:
            cols += [state.rel.last_start, state.rel.n_restarts,
                     state.rel.lost_work, state.rel.aborted.to(torch.int32)]
        back = torch.stack(cols)[:, :n].cpu().numpy().astype(np.int64)
        live = self.live
        live["jstate"], live["remaining"] = back[0], back[4]
        live["start"] = self._abs64(back[1], t0)
        live["finish"] = self._abs64(back[2], t0)
        live["rsv"] = self._abs64(back[3], t0)
        live["alloc_first"], live["alloc_span"], live["alloc_sum"] = back[5:8]
        if self.has_rel:
            live["last_start"] = back[8] + t0
            live["n_restarts"], live["lost_work"] = back[9], back[10]
            live["aborted"] = back[11].astype(bool)
            self.rel_ptr = state.rel.ptr[0]
            self.down = state.rel.down_host.copy()
        if self.machine is not None:
            rows = state.node_owner.cpu().numpy()
            self.owner_g = np.full(rows.shape[0], -1, dtype=np.int64)
            held = rows >= 0
            self.owner_g[held] = live["g"][rows[held]]
        self.free = int(state.free)
        self.clock = t0 + int(state.clock)
        self.n_events += state.n_events
        self.n_rounds += 1
        return state.n_events, bool(sat)

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _config(self) -> dict:
        return {
            "policy": self.policy_id,
            "total_nodes": self.total_nodes,
            "n_jobs": self.n_jobs,
            "trace_crc": self.trace_crc,
            "machine": self.machine is not None,
            "failures": self.has_rel,
        }

    def _save(self) -> None:
        tree = {f"live/{k}": v for k, v in self.live.items()}
        tree.update({f"res/{k}": v for k, v in self.results.items()})
        tree["owner_g"] = self.owner_g
        tree["down"] = self.down
        extra = {
            "round": self.round, "cursor": self.cursor,
            "clock": int(self.clock), "free": self.free,
            "rel_ptr": self.rel_ptr, "n_events": self.n_events,
            "window": self.window, "cap": self.cap,
            "n_rounds": self.n_rounds, "peak_live": self.peak_live,
            "flags": self.flags.as_dict(), "config": self._config(),
        }
        save_checkpoint(self.ckpt_dir, self.round, tree, extra=extra,
                        keep=self.keep)

    def _restore(self) -> None:
        leaves, _step, extra = load_checkpoint_raw(self.ckpt_dir)
        cfg = extra.get("config", {})
        if cfg != self._config():
            raise ReplayError(
                f"checkpoint in {self.ckpt_dir} was written by a different "
                f"replay configuration ({cfg} != {self._config()}); refusing "
                "to resume")
        self.live = {k[len("live/"):]: v for k, v in leaves.items()
                     if k.startswith("live/")}
        self.results = {k[len("res/"):]: v for k, v in leaves.items()
                        if k.startswith("res/")}
        self.owner_g = leaves["owner_g"]
        self.down = leaves["down"]
        for name in ("round", "cursor", "free", "rel_ptr", "n_events",
                     "window", "cap", "n_rounds", "peak_live"):
            setattr(self, name, int(extra[name]))
        self.clock = int(extra["clock"])
        self.flags = ReplayFlags.from_dict(extra["flags"])

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def run(self, *, resume: bool = False) -> ReplayResult:
        if resume:
            self._restore()
        while True:
            if self.ckpt_dir is not None and self.round % self.ckpt_every == 0:
                self._save()
            if (self._crash_after_round is not None
                    and self.round >= self._crash_after_round):
                raise ReplayInterrupted(
                    f"crash hook fired at round {self.round}")
            self.round += 1
            self._harvest()
            if self.cursor >= self.n_jobs and len(self.live["g"]) == 0:
                break
            t0 = int(self.clock)
            if (len(self.live["g"]) == 0
                    and self.t["submit"][self.cursor] - t0 > self.limit):
                # an idle gap wider than the int32 window: nothing is live,
                # so the host clock jumps to the next arrival
                t0 = self.clock = int(self.t["submit"][self.cursor])
            admitted = self._admit(t0)
            n_live = len(self.live["g"])
            self.peak_live = max(self.peak_live, n_live)
            if self.cursor < self.n_jobs:
                t_next = int(self.t["submit"][self.cursor]) - t0
                t_hi = min(t_next - 1, self.limit)
            else:
                t_hi = self.limit
            try:
                events, sat = self._run_round(t0, t_hi)
            except _RebaseOverflow:
                self.flags.rebase_overflows += 1
                if self.flags.rebase_overflows > 1:
                    raise ReplayError(
                        "window-relative time does not fit int32 even after "
                        "a window doubling; rescale the trace") from None
                self._double_window()
                continue
            if sat:
                # the truncated round is a valid prefix: count it, raise the
                # cap, and let the next round continue from the same state
                self.flags.saturated_rounds += 1
                if not self._cap_fixed:
                    self.cap *= 2
                    self.flags.cap_doublings += 1
                elif events == 0:
                    raise ReplayError(
                        f"event cap {self.cap} saturated with no progress; "
                        "raise max_events")
            if events == 0 and admitted == 0 and not sat:
                if self.cursor < self.n_jobs and n_live >= self.window:
                    self._double_window()   # more than W jobs alive at once
                elif self.cursor >= self.n_jobs:
                    # a drain round fired nothing: the next would be the
                    # same, so fail loud
                    raise ReplayError(
                        f"replay stalled draining {n_live} live jobs at "
                        f"clock {self.clock} (round {self.round}); no "
                        "event below the window limit can fire")
                else:
                    raise ReplayError(
                        f"replay stalled at clock {self.clock} (round "
                        f"{self.round}): no events below the window limit "
                        "and nothing to admit")
        return self._result()

    def _double_window(self) -> None:
        if self.flags.window_doublings >= self.max_window_doublings:
            raise ReplayError(
                f"active jobs exceed the window even after "
                f"{self.flags.window_doublings} doublings "
                f"(window={self.window}); raise window=")
        self.window *= 2
        self.flags.window_doublings += 1
        if not self._cap_fixed:
            self.cap = max(self.cap, self._default_cap(self.window))

    def _result(self) -> ReplayResult:
        r = self.results
        done = r["done"]
        fin = np.where(done, r["finish"], 0)
        # never-started or never-finished rows take the oracle's int64
        # sentinel -1: INF_TIME is a real instant on a horizon beyond int32
        started = r["start"] < INF64
        start = np.where(started, r["start"], np.int64(-1))
        finish = np.where(r["finish"] < INF64, r["finish"], np.int64(-1))
        return ReplayResult(
            submit=self.t["submit"], runtime=self.t["runtime"],
            estimate=self.t["estimate"], nodes=self.t["nodes"],
            priority=self.t["priority"],
            start=start, finish=finish,
            wait=np.where(started, start - self.t["submit"], 0),
            done=done,
            alloc_first=r["alloc_first"], alloc_span=r["alloc_span"],
            alloc_sum=r["alloc_sum"],
            n_restarts=r["n_restarts"], lost_work=r["lost_work"],
            aborted=r["aborted"],
            makespan=int(fin.max(initial=0)),
            n_events=self.n_events, n_rounds=self.n_rounds,
            peak_live=self.peak_live, window=self.window, flags=self.flags,
        )


def replay_trace(trace, policy="fcfs", *, total_nodes: int, **kwargs
                 ) -> ReplayResult:
    """One-call streaming replay: ``trace`` is a dict of host arrays or a
    path to an ``.swf``/``.swf.gz`` log.  See :class:`StreamingReplay` for
    the window, checkpoint and device knobs."""
    return StreamingReplay(trace, policy, total_nodes=total_nodes,
                           **kwargs).run()


def resume(ckpt_dir: str, trace, policy="fcfs", *, total_nodes: int,
           **kwargs) -> ReplayResult:
    """Restart a replay from its last durable round.

    Call with the same trace and configuration as the interrupted run
    (checked against the checkpoint's manifest; a mismatch refuses to
    resume).  The continuation equals an uninterrupted run."""
    kwargs.pop("ckpt_dir", None)
    return StreamingReplay(trace, policy, total_nodes=total_nodes,
                           ckpt_dir=ckpt_dir, **kwargs).run(resume=True)
