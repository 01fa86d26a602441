"""Malleable jobs on the card: the CUDA path equals the CPU path.

Needs a CUDA device (``cuda`` marker; skipped without one).  The CPU path
is held to the JAX package in ``test_torch_malleable.py`` and
``test_torch_mal_sweep.py``; here the card must give the same result dict,
column by column:

- elastic jobs on ``mesh2d`` under ``contiguous`` (placement, the largest
  free run in each resize tick's read, shrinks shedding the highest-index
  nodes, grows placed by the strategy), alone and under node failures;
- an elastic ensemble through ``sweep`` (the batched entries reading each
  member's width row);
- widths 3-8 under failures, solo and swept, in scalar mode and on a
  machine;
- the per-call width column of ``TableSelect`` and ``BatchedTableSelect``
  after in-place writes to it and after rebinding it to a new tensor: the
  kernel reads the column passed with the call, never a stale one.
"""

import numpy as np
import pytest
import torch

import repro_torch as rt

pytestmark = pytest.mark.cuda

ELASTIC = dict(curve="power", param=0.7, min_width=1, max_width=8,
               mode="elastic", interval=30, max_ticks=128,
               shrink_threshold=8, grow_threshold=2, step=2)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("failures", (False, True))
def test_elastic_mesh_contiguous_card_equals_cpu(failures):
    _need_cuda()
    from repro_torch.core import engine
    from repro_torch.kernels.queue_select import ops
    kw = {}
    if failures:
        kw["failures"] = rt.FailureModel(mtbf=2000.0, seed=3, mean_repair=50,
                                         horizon=8000, max_failures=256)
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=300, seed=4, congest=4),
                      topology=rt.Topology.mesh2d(4, 8), alloc="contiguous",
                      policy="backfill",
                      malleable=rt.MalleableModel(**ELASTIC), **kw)
    ops.reset_launches()
    engine.reset_counters()
    card = rt.run(scn, device="cuda").to_np()
    assert ops.queue_select.launches > 0
    assert engine.counters["resizes"] > 0
    _same(card, rt.run(scn, device="cpu").to_np())


def test_elastic_ensemble_card_equals_cpu():
    _need_cuda()
    from repro_torch.kernels.queue_select import ops
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=200, seed=2, congest=4),
                      total_nodes=32, policy="backfill",
                      malleable=rt.MalleableModel(**ELASTIC))
    axes = {"malleable.param": (0.3, 0.9), "policy": ("fcfs", "backfill",
                                                      "bestfit")}
    ops.reset_launches()
    card = rt.sweep(scn, axes=axes, device="cuda")
    assert ops.queue_select.batch_launches > 0
    assert ops.queue_select.launches == 0
    cpu = rt.sweep(scn, axes=axes, device="cpu")
    assert card.n_compiles == cpu.n_compiles == 1
    for a, b in zip(card.results, cpu.results):
        _same(a.to_np(), b.to_np())
        assert a.to_np()["mal_nresize"].sum() > 0


@pytest.mark.parametrize("machine", (False, True), ids=("scalar", "mesh2d"))
def test_min_width_above_one_under_failures_card_equals_cpu(machine):
    """Widths 3-8 under failures, backfill, solo and swept: dispatch
    offsets, failure shrinks and requeues to ``min_width`` on the card."""
    _need_cuda()
    from repro_torch.kernels.queue_select import ops
    kw = (dict(topology=rt.Topology.mesh2d(4, 8), alloc="contiguous")
          if machine else dict(total_nodes=32))
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=200, seed=2, congest=4),
                      policy="backfill", failures=rt.FailureModel(
                          mtbf=400.0, seed=3, mean_repair=50, horizon=4000,
                          max_failures=400),
                      malleable=rt.MalleableModel(**dict(
                          ELASTIC, curve="amdahl", param=0.1, min_width=3)),
                      **kw)
    ops.reset_launches()
    card = rt.run(scn, device="cuda").to_np()
    assert ops.queue_select.launches > 0
    _same(card, rt.run(scn, device="cpu").to_np())
    assert card["mal_width"][card["valid"]].min() >= 3
    assert card["mal_nresize"].sum() > 0 and card["n_restarts"].sum() > 0
    axes = {"policy": ("fcfs", "backfill")}
    for a, b in zip(rt.sweep(scn, axes=axes, device="cuda").results,
                    rt.sweep(scn, axes=axes, device="cpu").results):
        _same(a.to_np(), b.to_np())


def _table(n: int, B=None, seed=0):
    """Random columns (``[n]`` or ``[B, n]``) and state on the card, and a
    width column narrower than the bound nodes."""
    g = np.random.default_rng(seed)
    shape = (n,) if B is None else (B, n)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()

    cols = {"submit": dev(np.sort(g.integers(0, n // 2, shape), axis=-1)),
            "estimate": dev(g.choice([60, 600, 3600], shape)),
            "nodes": dev(g.integers(8, 64, shape)),
            "priority": dev(np.zeros(shape))}
    jstate = dev(g.choice([0, 1, 2, 3], shape, p=[0.1, 0.5, 0.3, 0.1]))
    rsv = dev(np.where(g.random(shape) < 0.5, 5000, 9000))
    width = dev(g.integers(1, 8, shape))
    return cols, jstate, rsv, width


def test_per_call_width_column_after_in_place_and_rebinding_writes():
    _need_cuda()
    from repro_torch.kernels.queue_select import ops, ref
    cols, jstate, rsv, width = _table(777)
    table = ops.TableSelect(cols)
    p = dict(clock=100, free=6, cap=6, shadow=7000, extra=2, exclude=0)

    def check(w):
        for mode in (ref.BESTFIT, ref.ANY_FIT, ref.BACKFILL_CAND):
            want = ref.fused_select_reference(mode, {**cols, "nodes": w},
                                              jstate, **p)
            assert table.select(mode, jstate, **p, nodes=w) == want
        assert ops.shadow_walk(table, jstate, rsv, 100, 6, 30, nodes=w) == \
            ref.shadow_walk_reference(w, jstate, rsv, 100, 6, 30)
        # a call without the column reads the bound one again
        assert table.select(ref.BESTFIT, jstate, **p) == \
            ref.fused_select_reference(ref.BESTFIT, cols, jstate, **p)

    ops.reset_launches()
    check(width)
    width[::3] = 7                        # in place: same address
    check(width)
    width = torch.where(jstate == 2, width + 1, width)   # a new tensor
    check(width)
    assert ops.queue_select.launches == 3 * 4
    assert ops.shadow_walk.launches == 3

    B = 4
    cols, jstate, rsv, width = _table(501, B, seed=1)
    stacked = ops.BatchedTableSelect(cols)

    def check_batch(w):
        reqs = [(b, ref.BESTFIT, ref.params(free=6, cap=6))
                for b in (3, 0, 2)]
        want = [ref.fused_select_reference(
            ref.BESTFIT, {c: t[b] for c, t in cols.items()} | {
                "nodes": w[b]}, jstate[b], free=6, cap=6)
            for b, _, _ in reqs]
        assert stacked.select_batch(reqs, jstate, nodes=w) == want
        walks = [(b, ref.params(clock=100, free=6, head_need=30))
                 for b in (1, 2)]
        assert stacked.walk_batch(walks, jstate, rsv, nodes=w) == [
            ref.shadow_walk_reference(w[b], jstate[b], rsv[b], 100, 6, 30)
            for b, _ in walks]

    check_batch(width)
    width[:, ::2] = 3
    check_batch(width)
    check_batch(torch.where(jstate == 2, width + 2, width))
    assert ops.queue_select.batch_launches == 3
    assert ops.shadow_walk.batch_launches == 3
