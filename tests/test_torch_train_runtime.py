"""The port's checkpoint manager, token pipeline and straggler monitor,
on the CPU: the reference's own tests of them (``test_ckpt_runtime.py``)
on the port, and each pipeline batch and each straggler decision equal to
the JAX package's."""

import os

import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.runtime.straggler import StragglerMonitor as JaxStragglerMonitor
from repro_torch.ckpt.store import (
    CheckpointManager, latest_step, load_checkpoint, save_checkpoint,
)
from repro_torch.data.pipeline import (
    MemmapTokens, SyntheticTokens, make_dataset,
)
from repro_torch.optim import adamw_init, compression_init
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.tree import tree_items


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn((8, 16), generator=g),
              "nested": {"b": torch.arange(10, dtype=torch.int32),
                         "c": torch.tensor(3.5)}}
    return params, adamw_init({"a": params["a"]})


def _equal(a, b):
    assert [k for k, _ in tree_items(a)] == [k for k, _ in tree_items(b)]
    for (k, x), (_, y) in zip(tree_items(a), tree_items(b)):
        assert torch.equal(x, y), k


def test_checkpoint_roundtrip(tmp_path):
    """Parameters, an OptState (a dataclass with a 0-d int32 step) and a
    0-d residual: keys, dtypes and values come back."""
    tree = (*_tree(), compression_init({"r": torch.zeros(3)}))
    save_checkpoint(str(tmp_path), 7, tree, extra={"data_step": 7})
    out, step, extra = load_checkpoint(str(tmp_path), tree)
    assert step == 7 and extra["data_step"] == 7
    _equal(out, tree)
    assert out[1].step.dtype == torch.int32 and type(out[1]) is type(tree[1])


def test_checkpoint_crc_detects_corruption(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 1, tree)
    victim = os.path.join(path, "leaf_00000.npy")
    arr = np.load(victim)
    arr.flat[0] += 1
    np.save(victim, arr)
    with pytest.raises(IOError, match="crc"):
        load_checkpoint(str(tmp_path), tree)


def test_checkpoint_refuses_a_wrong_template(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path), ({"a": torch.zeros(8, 15),
                                         "nested": tree[0]["nested"]},
                                        tree[1]))
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(str(tmp_path), {"other": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), tree)


def test_checkpoint_keep_k(tmp_path):
    tree = _tree()
    for s in range(6):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_4", "step_5"]
    assert latest_step(str(tmp_path)) == 5


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_snapshots_before_it_returns(tmp_path, async_save):
    """The manager copies the tree to host memory before ``save`` returns,
    so an in-place update right after (the optimizer's) cannot reach the
    checkpoint; keep-k holds across saves."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    tree = _tree()
    want = tree[0]["a"].clone()
    for step in (3, 4, 5):
        mgr.save(step, tree, extra={"data_step": step})
        tree[0]["a"].add_(1.0)                   # the next step's update
    mgr.wait()
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    out, step, extra = mgr.restore(tree, step=4)
    assert step == 4 and extra == {"data_step": 4}
    assert torch.equal(out[0]["a"], want + 1.0)


def test_data_replay_determinism():
    ds = SyntheticTokens(1000, batch=2, seq=16, seed=9)
    first = [next(ds)["tokens"].copy() for _ in range(5)]
    ds.state.step = 0                            # a checkpoint restore
    replay = [next(ds)["tokens"].copy() for _ in range(5)]
    for a, b in zip(first, replay):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,shard", [(0, 0), (9, 0), (9, 3)])
def test_synthetic_batches_equal_jax(seed, shard):
    kw = dict(seed=seed, shard=shard, num_shards=4)
    ours = SyntheticTokens(512, 4, 32, **kw)
    ref = jax_pipeline.SyntheticTokens(512, 4, 32, **kw)
    for _ in range(4):
        a, b = next(ours), next(ref)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.state.to_dict() == ref.state.to_dict() == {
        "seed": seed, "step": 4}


def test_memmap_batches_equal_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.arange(10_000, dtype=np.int32).tofile(path)
    ours = make_dataset("memmap", vocab=0, batch=3, seq=32, path=path, seed=4)
    ref = jax_pipeline.make_dataset("memmap", vocab=0, batch=3, seq=32,
                                    path=path, seed=4)
    assert isinstance(ours, MemmapTokens)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a["tokens"].shape == (3, 32)
        np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="data-path"):
        make_dataset("memmap", vocab=0, batch=1, seq=1)


def test_straggler_monitor_flags_slow_rank():
    mon = StragglerMonitor(4, warn_ratio=1.3, evict_ratio=2.0, patience=3)
    decisions = []
    for step in range(20):
        times = [0.1, 0.1, 0.1, 0.1]
        if step >= 8:
            times[2] = 0.5                       # rank 2 becomes 5x slower
        decisions += mon.update(times)
    assert any(d.rank == 2 and d.action == "evict" for d in decisions)
    assert all(d.rank == 2 for d in decisions)


def test_straggler_decisions_equal_jax():
    rng = np.random.default_rng(0)
    ours, ref = StragglerMonitor(3, patience=2), JaxStragglerMonitor(
        3, patience=2)
    for step in range(60):
        times = list(rng.lognormal(0.0, 0.4, 3))
        got, want = ours.update(times), ref.update(times)
        assert [vars(d) for d in got] == [vars(d) for d in want], step
    assert ours.summary() == ref.summary()
    ours, ref = StragglerMonitor(1), JaxStragglerMonitor(1)
    got, want = [], []
    for dt in [0.1] * 5 + [0.5] * 5:             # the trainer's scalar form
        got += [vars(d) for d in ours.update(dt)]
        want += [vars(d) for d in ref.update(dt)]
    assert got == want == [{"step": 8, "rank": 0, "ratio": 5.0,
                            "action": "evict"}]
