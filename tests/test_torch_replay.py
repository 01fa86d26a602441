"""Streaming trace replay of the PyTorch port against the JAX package's
(``repro.replay.replay_trace``) and the port's host oracle
(``repro_torch.refsim.replay_reference``), on the CPU.

- ``tests/test_replay.py``'s ten fast tests: tiny windows through the
  doubling ladder, a window larger than the trace, cap saturation with
  and without doubling, failures across rounds, kill and resume, the
  configuration refusal, a horizon beyond int32, dependencies refused,
  the summary;
- its differential grid (fcfs, sjf, backfill, preempt x scalar and
  mesh2d+contiguous x failures off/on) at the smallest size that still
  crosses rounds;
- hypothesis: a kill after a random round resumes to the same result; the
  result is the same for every window the ladder can reach (ROADMAP
  Queue 3: the reference's own property draws windows it cannot);
- the checkpoint store's round trip and crc refusal, ``dump_swf``'s round
  trip through ``load_swf``, and the CLI on a tiny SWF.

Every replay is compared with the JAX package's field by field.
"""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro_torch as rt
from repro import api
from repro.replay import replay_trace as jax_replay_trace
from repro.traces import das2_like
from repro_torch.ckpt import latest_step, load_checkpoint_raw, save_checkpoint
from repro_torch.core.jobs import make_jobset
from repro_torch.refsim import replay_reference
from repro_torch.replay import (
    ReplayError, ReplayInterrupted, StreamingReplay, replay_trace, resume,
)
from repro_torch.replay.__main__ import main as replay_main
from repro_torch.traces.swf import dump_swf, load_swf

TOTAL = 32


def _trace(n=300, seed=2):
    t = dict(das2_like(n, seed=seed))
    t["priority"] = np.random.default_rng(seed).integers(0, 4, n)
    return t


FAIL_KW = dict(mtbf=30_000.0, mean_repair=2_000, horizon=1 << 19, seed=7,
               max_failures=64, checkpoint_interval=500, restart_overhead=20)


def _failures(mod):
    return mod.FailureModel(**FAIL_KW).materialize(TOTAL)


def replay_both(t, policy, *, machine=None, alloc=None, failures=False,
                **kw):
    """The port's replay on the CPU, after checking it against the JAX
    package's field by field (flags and scalars included)."""
    res = replay_trace(
        dict(t), policy, total_nodes=TOTAL, device="cpu",
        machine=None if machine is None else rt.Topology(*machine).build(
            "cpu"),
        alloc=alloc, failures=_failures(rt) if failures else None, **kw)
    ref = jax_replay_trace(
        dict(t), policy, total_nodes=TOTAL,
        machine=None if machine is None else api.Topology(*machine).build(),
        alloc=alloc, failures=_failures(api) if failures else None, **kw)
    for f in dataclasses.fields(ref):
        a, b = getattr(res, f.name), getattr(ref, f.name)
        if f.name == "flags":
            assert a.as_dict() == b.as_dict()
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    return res


def _assert_vs_oneshot(res, t, policy, **kw):
    js = make_jobset(t["submit"], t["runtime"], t["nodes"], t["estimate"],
                     priority=t.get("priority"), total_nodes=TOTAL,
                     device="cpu")
    one = rt.simulate(js, policy, TOTAL, device="cpu", **kw)
    np.testing.assert_array_equal(res.start, one.start.numpy())
    np.testing.assert_array_equal(res.finish, one.finish.numpy())
    np.testing.assert_array_equal(res.done, one.done.numpy())
    assert res.n_events == one.n_events


def _assert_vs_refsim(res, t, policy, machine=None, alloc="simple",
                      failures=False):
    ref = replay_reference(
        t, policy, total_nodes=TOTAL,
        machine=None if machine is None else rt.Topology(*machine).build(
            "cpu"),
        alloc=alloc, failures=_failures(rt) if failures else None)
    np.testing.assert_array_equal(res.start, ref["start"])
    np.testing.assert_array_equal(res.finish[res.done],
                                  ref["finish"][ref["done"]])
    np.testing.assert_array_equal(res.wait[res.done],
                                  ref["wait"][ref["done"]])
    np.testing.assert_array_equal(res.done, ref["done"])
    assert res.n_events == int(ref["n_events"])
    if machine is not None:
        for key in ("alloc_first", "alloc_span", "alloc_sum"):
            np.testing.assert_array_equal(getattr(res, key), ref[key])
    if failures:
        for key in ("n_restarts", "lost_work", "aborted"):
            np.testing.assert_array_equal(getattr(res, key), ref[key])


def _same_result(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


# ---------------------------------------------------------------------------
# tests/test_replay.py's fast lane
# ---------------------------------------------------------------------------


def test_tiny_window_bitexact_and_bounded():
    t = _trace(200)
    res = replay_both(t, "backfill", window=16)
    _assert_vs_oneshot(res, t, "backfill")
    _assert_vs_refsim(res, t, "backfill")
    assert res.flags.window_doublings >= 1
    assert res.peak_live <= res.window
    assert res.n_rounds > 1


def test_window_larger_than_trace_single_round():
    t = _trace(80)
    res = replay_both(t, "fcfs", window=256)
    _assert_vs_oneshot(res, t, "fcfs")
    assert res.flags.window_doublings == 0


def test_event_cap_saturation_flagged_and_recovered():
    t = _trace(150)
    runner = StreamingReplay(dict(t), "fcfs", total_nodes=TOTAL, window=64,
                             device="cpu")
    runner.cap = 8   # saturate the first busy round
    res = runner.run()
    _assert_vs_oneshot(res, t, "fcfs")
    _assert_vs_refsim(res, t, "fcfs")
    assert res.flags.saturated_rounds >= 1
    assert res.flags.cap_doublings >= 1


def test_fixed_event_cap_saturates_without_doubling():
    t = _trace(100)
    res = replay_both(t, "sjf", window=128, max_events=16)
    _assert_vs_oneshot(res, t, "sjf")
    assert res.flags.saturated_rounds >= 1
    assert res.flags.cap_doublings == 0


def test_failures_cross_window_rounds():
    t = _trace(150)
    res = replay_both(t, "fcfs", window=32, failures=True)
    _assert_vs_oneshot(res, t, "fcfs", failures=_failures(rt))
    _assert_vs_refsim(res, t, "fcfs", failures=True)
    assert int(res.n_restarts.sum()) > 0


def test_kill_then_resume_byte_identical(tmp_path):
    t = _trace(150)
    kw = dict(total_nodes=TOTAL, window=48, device="cpu")
    full = replay_both(t, "backfill", window=48)
    ck = str(tmp_path / "ck")
    with pytest.raises(ReplayInterrupted):
        StreamingReplay(dict(t), "backfill", ckpt_dir=ck, ckpt_every=1,
                        _crash_after_round=3, **kw).run()
    _same_result(full, resume(ck, dict(t), "backfill", **kw))


def test_resume_refuses_config_mismatch(tmp_path):
    t = _trace(100)
    ck = str(tmp_path / "ck")
    with pytest.raises(ReplayInterrupted):
        StreamingReplay(dict(t), "fcfs", total_nodes=TOTAL, window=48,
                        ckpt_dir=ck, ckpt_every=1, _crash_after_round=2,
                        device="cpu").run()
    with pytest.raises(ReplayError, match="different replay configuration"):
        resume(ck, dict(t), "sjf", total_nodes=TOTAL, window=48,
               device="cpu")


def test_beyond_int32_horizon_replays_against_refsim():
    base = _trace(60, seed=4)
    far = {k: v.copy() for k, v in base.items()}
    far["submit"] = far["submit"] + (np.int64(3) << 31)
    t = {k: np.concatenate([base[k], far[k]]) for k in base}
    with pytest.raises(ValueError, match="overflows int32"):
        make_jobset(t["submit"], t["runtime"], t["nodes"], t["estimate"],
                    total_nodes=TOTAL, device="cpu")
    res = replay_both(t, "backfill", window=64)
    _assert_vs_refsim(res, t, "backfill")
    assert res.makespan > 2 ** 31
    assert res.done.all()
    assert res.flags.rebase_overflows == 0


def test_deps_rejected():
    t = _trace(20)
    t["deps"] = [(1, 0)]
    with pytest.raises(ValueError, match="dependency-free"):
        replay_trace(t, "fcfs", total_nodes=TOTAL, device="cpu")


def test_summary_shape():
    t = _trace(80)
    res = replay_both(t, "fcfs", window=96)
    s = res.summary()
    assert s["n_done"] == 80 and s["n_jobs"] == 80
    assert s["makespan"] == res.makespan > 0
    assert s["p95_wait"] >= s["p50_wait"] >= 0
    assert set(s["flags"]) == {"saturated_rounds", "cap_doublings",
                               "window_doublings", "rebase_overflows"}


# ---------------------------------------------------------------------------
# the differential grid, at the smallest size that crosses rounds
# ---------------------------------------------------------------------------


# preemption is scalar-counter mode only, as in the reference's grid
GRID = [(p, m) for p in ("fcfs", "sjf", "backfill", "preempt")
        for m in ("scalar", "mesh") if (p, m) != ("preempt", "mesh")]


@pytest.mark.parametrize("failures", (False, True), ids=("nofail", "fail"))
@pytest.mark.parametrize("policy,mode", GRID, ids=lambda x: x)
def test_differential_grid(policy, mode, failures):
    t = _trace(120)
    machine = ("mesh2d", (4, 8)) if mode == "mesh" else None
    alloc = "contiguous" if mode == "mesh" else None
    res = replay_both(t, policy, window=32, machine=machine, alloc=alloc,
                      failures=failures)
    assert res.n_rounds > 1
    _assert_vs_refsim(res, t, policy, machine=machine,
                      alloc=alloc or "simple", failures=failures)


# ---------------------------------------------------------------------------
# properties
# ---------------------------------------------------------------------------

_PROP_TRACE = _trace(400, seed=6)


@given(window=st.integers(12, 160),
       policy=st.sampled_from(["fcfs", "backfill"]))
@settings(max_examples=5, deadline=None)
def test_property_window_invariant_where_the_ladder_reaches(window, policy):
    """Every window the doubling ladder can reach gives the one-shot
    schedule, the oracle's and the reference replay's."""
    res = replay_both(_PROP_TRACE, policy, window=window)
    _assert_vs_oneshot(res, _PROP_TRACE, policy)
    _assert_vs_refsim(res, _PROP_TRACE, policy)
    assert res.peak_live <= res.window


@given(window=st.integers(12, 96), crash_round=st.integers(1, 12))
@settings(max_examples=8, deadline=None)
def test_property_kill_at_random_round_resumes_identical(window,
                                                         crash_round):
    t = _trace(250, seed=8)
    kw = dict(total_nodes=TOTAL, window=window, device="cpu")
    full = replay_trace(dict(t), "fcfs", **kw)
    with tempfile.TemporaryDirectory() as ck:
        try:
            StreamingReplay(dict(t), "fcfs", ckpt_dir=ck, ckpt_every=1,
                            _crash_after_round=crash_round, **kw).run()
            return   # the run finished before the crash round
        except ReplayInterrupted:
            pass
        _same_result(full, resume(ck, dict(t), "fcfs", **kw))


# ---------------------------------------------------------------------------
# the checkpoint store, dump_swf and the CLI
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_and_crc_refusal(tmp_path):
    ck = str(tmp_path / "ck")
    tree = {"live/g": np.arange(5), "res/done": np.ones(3, bool),
            "nested": {"b": np.zeros((2, 2)), "a": [np.int64(7)]}}
    for step in range(5):
        save_checkpoint(ck, step, tree, extra={"round": step}, keep=2)
    assert latest_step(ck) == 4
    assert sorted(os.listdir(ck)) == ["step_3", "step_4"]
    leaves, step, extra = load_checkpoint_raw(ck)
    assert step == 4 and extra == {"round": 4}
    assert sorted(leaves) == ["live/g", "nested/a/0", "nested/b",
                              "res/done"]
    np.testing.assert_array_equal(leaves["live/g"], np.arange(5))
    path = os.path.join(ck, "step_4", "manifest.json")
    manifest = json.load(open(path))
    rec = next(r for r in manifest["leaves"] if r["key"] == "live/g")
    np.save(os.path.join(ck, "step_4", rec["file"]), np.arange(1, 6))
    with pytest.raises(IOError, match="crc mismatch"):
        load_checkpoint_raw(ck)
    load_checkpoint_raw(ck, step=3)
    with pytest.raises(FileNotFoundError):
        load_checkpoint_raw(str(tmp_path / "none"))


@pytest.mark.parametrize("suffix", (".swf", ".swf.gz"))
def test_dump_swf_round_trips_through_load_swf(tmp_path, suffix):
    t = das2_like(50, seed=5)
    path = str(tmp_path / f"t{suffix}")
    assert dump_swf(path, t, comment="synthetic\nDAS-2-like") == 50
    back, report = load_swf(path)
    assert report.n_jobs == 50
    for k in ("submit", "runtime", "nodes", "estimate"):
        np.testing.assert_array_equal(back[k], t[k] - (
            t["submit"].min() if k == "submit" else 0))


def test_cli_on_a_tiny_swf(tmp_path, capsys):
    t = das2_like(60, seed=9)
    path = str(tmp_path / "tiny.swf")
    dump_swf(path, t)
    out = str(tmp_path / "summary.json")
    ck = str(tmp_path / "ck")
    assert replay_main([path, "--nodes", str(TOTAL), "--policy", "backfill",
                        "--window", "16", "--ckpt-dir", ck,
                        "--ckpt-every", "1", "--out", out,
                        "--device", "cpu"]) == 0
    s = json.load(open(out))
    want = replay_both(load_swf(path)[0], "backfill", window=16).summary()
    assert {k: s[k] for k in want} == want
    assert s["trace"].endswith("0 quarantined)")
    assert replay_main([path, "--nodes", str(TOTAL), "--policy", "backfill",
                        "--window", "16", "--ckpt-dir", ck, "--resume",
                        "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["n_done"] == 60
