"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (a CUDA kernel has no
CPU mode).  The file imports neither JAX nor the JAX package, so that it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.queue_select import ops
from repro_torch.kernels.queue_select.ref import queue_select_reference


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    for n in (1, 7, 1000, 73_496, 1 << 20):
        for rate in (0.0, 0.05, 0.5, 1.0):
            s = torch.from_numpy(
                rng.integers(-1000, 1001, n).astype(np.int32)).cuda()
            m = torch.from_numpy(rng.random(n) < rate).cuda()
            for mask in (m, m.to(torch.int32)):
                before = ops.queue_select.launches
                got = ops.queue_select(s, mask)
                assert ops.queue_select.launches == before + 1
                want = queue_select_reference(s, mask)
                torch.cuda.synchronize()
                assert got.tolist() == want.tolist()


@pytest.mark.cuda
def test_kernel_corners_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    big = torch.full((50,), 2**30 - 1, dtype=torch.int32, device="cuda")
    feas = torch.zeros(50, dtype=torch.bool, device="cuda")
    feas[[31, 17]] = True
    assert ops.queue_select(big, feas).tolist() == [17, 2**30 - 1]
    s = torch.tensor([5, -3, -2**31, 7, -2**31 + 1], dtype=torch.int32,
                     device="cuda")
    m = torch.tensor([1, 1, 0, 1, 1], dtype=torch.int32, device="cuda")
    assert ops.queue_select(s, m).tolist() == [4, -2**31 + 1]
    assert ops.queue_select(s, torch.zeros_like(m)).tolist() == [-1, 2**30 - 1]
    with pytest.raises(ValueError, match="contiguous"):
        ops.queue_select(torch.zeros(8, dtype=torch.int32, device="cuda")[::2],
                         torch.ones(4, dtype=torch.bool, device="cuda"))


# the fused selections and the walk: sizes around one cluster's 8 x 1,024
# threads, and the archive run's table
SELECT_SIZES = (7, 1000, 8191, 8192, 8193, 73_496)
BIG = 2**30 - 1


def _random_table(rng, n, running_share):
    """A random job table and mid-run state on the card (ties in submit and
    estimate, priorities on either side of BIG, reservations before and
    after the clock): (TableSelect, jstate, rsv_finish, clock)."""
    cols = {"submit": np.sort(rng.integers(0, max(n // 3, 1), n)),
            "estimate": rng.choice([60, 600, 3600, 43_200], n),
            "nodes": rng.integers(1, 129, n),
            "priority": BIG + rng.integers(-3, 3, n)}
    rest = (1 - running_share) / 4
    jstate = rng.choice([0, 1, 2, 3], n, p=[rest, 2 * rest, running_share,
                                             rest])
    clock = 50_000
    rsv = np.where(jstate == 2, clock + rng.integers(-3000, 40_000, n), BIG)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()
    table = ops.TableSelect({c: dev(cols[c]) for c in ops.COLUMNS})
    return table, dev(jstate), dev(rsv), clock


@pytest.mark.cuda
@pytest.mark.parametrize("n", SELECT_SIZES)
def test_fused_modes_and_walk_match_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.queue_select import ref
    rng = np.random.default_rng(n)
    for share in (0.02, 0.3):
        table, jstate, rsv, clock = _random_table(rng, n, share)
        nodes = table.cols["nodes"]
        run_nodes = int(torch.where(jstate == 2, nodes, 0).sum())
        for free, need in ((0, 1), (7, 40), (2, run_nodes // 2),
                           (1, run_nodes + 2)):
            before = ops.shadow_walk.launches
            walk = ops.shadow_walk(table, jstate, rsv, clock, free, need)
            assert ops.shadow_walk.launches == before + 1
            assert walk == ref.shadow_walk_reference(nodes, jstate, rsv,
                                                     clock, free, need)
            head = ref.fused_select_reference(ref.HEAD_SUBMIT, table.cols,
                                              jstate)[0]
            tier = ref.fused_select_reference(ref.PREEMPT_TIER, table.cols,
                                              jstate)[1]
            for extra in (walk[1], -1):
                p = dict(clock=clock, free=free, cap=free + 1, shadow=walk[0],
                         extra=extra, exclude=head, tier=tier)
                for name, mode in ref.MODES.items():
                    before = ops.queue_select.launches
                    got = table.select(mode, jstate, **p)
                    assert ops.queue_select.launches == before + 1
                    want = ref.fused_select_reference(mode, table.cols,
                                                      jstate, **p)
                    assert got == want, (name, p)


@pytest.mark.cuda
def test_backfill_run_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import repro_torch as rt
    from repro_torch.core import engine
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=400, seed=2,
                                              kind="das2"),
                      total_nodes=400, policy="backfill")
    ops.reset_launches()
    engine.reset_counters()
    card = rt.run(scn).to_np()
    assert ops.shadow_walk.launches > 0 and ops.queue_select.launches > 0
    assert engine.counters["max_walks_per_event"] <= 1
    cpu = rt.run(scn, device="cpu").to_np()
    for k in ("start", "finish", "n_events"):
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)


def _stacked_requests(rng, ref, table, jstate, rsv, clock):
    """Random select and walk requests over a stacked table, some members
    idle, the modes mixed, scalars as the engine derives them."""
    members = [b for b in range(table.batch) if rng.random() < 0.75] or [0]
    selects, walks = [], []
    for b in rng.permutation(members).tolist():
        cols = {c: t[b].cpu() for c, t in table.cols.items()}
        js, rs = jstate[b].cpu(), rsv[b].cpu()
        free = int(rng.integers(0, 40))
        need = int(rng.integers(1, 2000))
        shadow, extra, _ = ref.shadow_walk_reference(cols["nodes"], js, rs,
                                                     clock, free, need)
        head = ref.fused_select_reference(ref.HEAD_SUBMIT, cols, js)[0]
        tier = ref.fused_select_reference(ref.PREEMPT_TIER, cols, js)[1]
        mode = int(rng.integers(0, len(ref.MODES)))
        selects.append((b, mode, ref.params(
            clock=clock, free=free, cap=free + 1, shadow=shadow,
            extra=(extra, -1)[int(rng.integers(0, 2))], exclude=head,
            tier=tier)))
        walks.append((b, ref.params(clock=clock, free=free, head_need=need)))
    return selects, walks


@pytest.mark.cuda
@pytest.mark.parametrize("n", (7, 1000, 8193))
def test_batched_entries_match_plain_and_solo_on_card(n):
    """One batched launch a call; each answer equals the batched plain
    version and the solo kernel on the member's row, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.queue_select import ref
    rng = np.random.default_rng(n + 1)
    B = 6
    parts = [_random_table(rng, n, share) for share in
             (0.02, 0.3, 0.1, 0.02, 0.4, 0.05)[:B]]
    cols = {c: torch.stack([p[0].cols[c] for p in parts]) for c in ops.COLUMNS}
    jstate = torch.stack([p[1] for p in parts])
    rsv = torch.stack([p[2] for p in parts])
    clock = parts[0][3]
    card = ops.BatchedTableSelect(cols)
    plain = ops.BatchedTableSelect({c: t.cpu() for c, t in cols.items()})
    for _ in range(6):
        selects, walks = _stacked_requests(rng, ref, card, jstate, rsv, clock)
        solo = ops.queue_select.launches
        before = ops.queue_select.batch_launches
        got = card.select_batch(selects, jstate)
        assert ops.queue_select.batch_launches == before + 1
        assert ops.queue_select.launches == solo
        assert got == plain.select_batch(selects, jstate.cpu())
        for (b, mode, p), g in zip(selects, got):
            row = ops.TableSelect({c: t[b] for c, t in cols.items()})
            assert g == row.select(mode, jstate[b], *p[:-1]), (b, mode, p)
        before = ops.shadow_walk.batch_launches
        got = card.walk_batch(walks, jstate, rsv)
        assert ops.shadow_walk.batch_launches == before + 1
        assert got == plain.walk_batch(walks, jstate.cpu(), rsv.cpu())
        for (b, p), g in zip(walks, got):
            row = ops.TableSelect({c: t[b] for c, t in cols.items()})
            assert g == ops.shadow_walk(row, jstate[b], rsv[b], p[0], p[1],
                                        p[-1]), (b, p)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(8, 165), (24, 2625), (32, 165),
                                 (3, 8193)])
def test_batched_generic_entry_matches_plain_on_card(B, T):
    """queue_select_batch: one launch a call, each row's answer equal to
    the plain version's and the solo kernel's, bit for bit, with rows all
    infeasible, all tied and scoring BIG, and either mask type."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.queue_select.ref import (
        BIG, queue_select_batched_reference,
    )
    rng = np.random.default_rng(B * T)
    scores = rng.integers(-1000, 1001, (B, T)).astype(np.int32)
    feas = rng.random((B, T)) < rng.choice([0.0, 0.01, 0.5, 1.0], (B, 1))
    scores[0] = BIG
    scores[1 % B] = 7
    s = torch.from_numpy(scores).cuda()
    for mask in (torch.from_numpy(feas).cuda(),
                 torch.from_numpy(feas.astype(np.int32)).cuda()):
        for members in (list(range(B)), [B - 1, 0, B // 2, 0],
                        [int(b) for b in rng.permutation(B)[:max(B // 3, 1)]]):
            before = ops.queue_select_batch.launches
            got = ops.queue_select_batch(s, mask, members)
            assert ops.queue_select_batch.launches == before + 1
            assert got == queue_select_batched_reference(s.cpu(), mask.cpu(),
                                                         members)
            for b, g in zip(members, got):
                assert g == tuple(ops.queue_select(s[b], mask[b]).tolist())


@pytest.mark.cuda
def test_sweep_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import repro_torch as rt
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=300, seed=2,
                                              kind="sdsc_sp2", congest=4),
                      total_nodes=128)
    axes = {"policy": ("fcfs", "sjf", "ljf", "bestfit", "backfill",
                       "preempt"), "total_nodes": (64, 128)}
    ops.reset_launches()
    card = rt.sweep(scn, axes=axes)
    assert ops.queue_select.batch_launches > 0
    assert ops.shadow_walk.batch_launches > 0
    assert ops.queue_select.launches == ops.shadow_walk.launches == 0
    cpu = rt.sweep(scn, axes=axes, device="cpu")
    for (point, a), (_, b) in zip(card, cpu):
        for k in ("start", "finish", "n_events", "makespan", "done"):
            np.testing.assert_array_equal(a.to_np()[k], b.to_np()[k],
                                          err_msg=f"{point} {k}")


# (B, Sq, Sk, H, KV, hd): the CPU sweep's shapes, plus the models' head
# dims 80 and 128 with GQA and the serve shape's groups (G = 3)
FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64),
    (1, 128, 384, 8, 8, 128),
    (2, 200, 200, 4, 1, 64),
    (1, 1, 256, 8, 2, 64),
    (2, 64, 512, 4, 4, 32),
    (2, 160, 160, 8, 2, 80),
    (1, 300, 300, 24, 8, 128),
]
FLASH_MASKS = [(True, None), (True, 96), (False, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_reference
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = 2e-5 if dt == torch.float32 else 2e-2
    rng = np.random.default_rng(0)
    for B, Sq, Sk, H, KV, hd in FLASH_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, s, n, hd), dtype=np.float32)).to("cuda", dt)
            for s, n in ((Sq, H), (Sk, KV), (Sk, KV)))
        qoff = Sk - Sq
        for causal, window in FLASH_MASKS:
            before = fops.flash_attention.launches
            got = fops.flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=qoff)
            assert fops.flash_attention.launches == before + 1
            want = attention_reference(q, k, v, causal=causal, window=window,
                                       q_offset=qoff)
            torch.cuda.synchronize()
            assert got.dtype == dt and got.shape == q.shape
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       atol=tol, rtol=tol)


# bf16 only, the sm90 kernel's tiling: hd 80 with stablelm-3b's heads,
# h2o-danube-1.8b's heads and window over 4,608 positions, Sk = 2,049
FLASH_BF16_CASES = [
    ((1, 2048, 2048, 32, 32, 80), FLASH_MASKS),
    ((1, 4608, 4608, 32, 8, 80), [(True, 4096)]),
    ((1, 2049, 2049, 24, 8, 128), FLASH_MASKS),
    ((2, 77, 2049, 24, 8, 128), FLASH_MASKS),
]


@pytest.mark.cuda
def test_flash_sm90_tiling_cases_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_reference
    rng = np.random.default_rng(1)
    for (B, Sq, Sk, H, KV, hd), masks in FLASH_BF16_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, s, n, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
            for s, n in ((Sq, H), (Sk, KV), (Sk, KV)))
        for causal, window in masks:
            kw = dict(causal=causal, window=window, q_offset=Sk - Sq)
            got = fops.flash_attention(q, k, v, **kw)
            want = attention_reference(q, k, v, **kw)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_flash_routes_by_dtype_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import ops as fops
    q = torch.randn(1, 256, 8, 128, device="cuda")
    k = torch.randn(1, 256, 2, 128, device="cuda")
    fops.reset_launches()
    fops.flash_attention(q, k, k)
    assert fops.flash_attention.launches_by_route == {"sm90_bf16": 0, "f32": 1}
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    out = fops.flash_attention(qb, kb, kb)
    assert out.dtype == torch.bfloat16
    assert fops.flash_attention.launches_by_route == {"sm90_bf16": 1, "f32": 1}
    assert fops.flash_attention.launches == 2
    # a [B, S, H, hd] view of a [B, H, S, hd] tensor goes to TMA as it is
    qt = qb.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(fops.flash_attention(qt, kb, kb), out)
    # what TMA cannot take raises, and launches nothing
    odd = torch.zeros(1, 256, 8, 132, device="cuda",
                      dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        fops.flash_attention(odd, kb, kb)
    assert fops.flash_attention.launches == 3
    fops.reset_launches()


# (B, H, S, K): the CPU sweep's shapes (test_kernels.py::test_linattn_sweep)
# plus K = 128 and ragged lengths past one 32-step tile; bf16 at K 64 and
# 128 runs on the sm90 kernel, the rest on the CUDA-core kernel
LINATTN_SHAPES = [
    (2, 3, 64, 16),
    (1, 2, 128, 64),
    (2, 1, 100, 32),
    (1, 4, 256, 64),
    (1, 2, 77, 128),
    (2, 2, 33, 64),
]


def _linattn_inputs(rng, B, H, S, K, dt, logw=None):
    r, k, v = (torch.from_numpy(rng.standard_normal(
        (B, H, S, K), dtype=np.float32) * 0.5).to("cuda", dt)
        for _ in range(3))
    if logw is None:
        lw = -np.exp(rng.standard_normal((B, H, S, K), dtype=np.float32) * 0.5)
    else:
        lw = np.full((B, H, S, K), logw, np.float32)
    u = torch.from_numpy(rng.standard_normal((H, K), dtype=np.float32)
                         * 0.5).cuda()
    return r, k, v, torch.from_numpy(lw).cuda(), u


def _linattn_errs(got, want):
    """Errors relative to the largest reference entry, as test_kernels.py
    measures them: (y, state)."""
    (y, s), (wy, ws) = got, want
    ey = (y.float() - wy.float()).abs().max() / (wy.float().abs().max() + 1e-6)
    es = (s - ws).abs().max() / (ws.abs().max() + 1e-6)
    return float(ey), float(es)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linattn_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.linattn_scan import ops as lops
    from repro_torch.kernels.linattn_scan.ref import linattn_reference
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 5e-2
    rng = np.random.default_rng(0)
    for B, H, S, K in LINATTN_SHAPES:
        args = _linattn_inputs(rng, B, H, S, K, dt)
        before = lops.linattn.launches
        got = lops.linattn(*args, return_state=True)
        assert lops.linattn.launches == before + 1
        want = linattn_reference(*args)
        torch.cuda.synchronize()
        assert got[0].dtype == dt and got[1].dtype == torch.float32
        ey, es = _linattn_errs(got, want)
        assert ey < tol and es < 1e-4, ((B, H, S, K), ey, es)
        # the model's layout: [B, H, S, K] views of [B, S, H, K] tensors
        views = [x.transpose(1, 2).contiguous().transpose(1, 2)
                 for x in args[:4]]
        y, s = lops.linattn(*views, args[4], return_state=True)
        assert torch.equal(y, got[0]) and torch.equal(s, got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("logw,S", [(-6.0, 256), (-float(np.exp(-6.0)), 2045)])
def test_linattn_kernel_steep_and_slow_decay_on_card(logw, S, dtype):
    """f32 on the CUDA-core kernel, bf16 on the sm90 kernel (K = 64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.linattn_scan import ops as lops
    from repro_torch.kernels.linattn_scan.ref import linattn_reference
    dt = getattr(torch, dtype)
    args = _linattn_inputs(np.random.default_rng(1), 1, 2, S, 64, dt,
                           logw=logw)
    lops.reset_launches()
    got = lops.linattn(*args, return_state=True)
    assert lops.linattn.launches_by_route[lops.route(dt, 64)] == 1
    assert torch.isfinite(got[0].float()).all() and torch.isfinite(got[1]).all()
    ey, es = _linattn_errs(got, linattn_reference(*args))
    assert ey < (1e-4 if dt == torch.float32 else 5e-2) and es < 1e-4, (ey, es)


# bf16 on the sm90 kernel: steep decays at both key dims, per-channel
# decays from -30 to -1e-6 a step ("mixed"), ragged lengths.  A case's
# inputs are a function of the case alone: numpy's generator is seeded by
# S + K, and the mixed decays' factor comes from a CUDA generator seeded by
# S + K too ("mixed") or by the seed the case names ("mixed:<seed>"),
# never from torch's global generator, whose state depends on every draw
# made before in the process.
LINATTN_SM90_CASES = [
    (1, 2, 256, 64, -6.0), (1, 2, 200, 128, -30.0),
    (2, 4, 333, 64, "mixed"), (1, 3, 130, 128, "mixed"), (2, 2, 33, 128, None),
    # draws under which the kernel left the statement test's former y
    # tolerance (1e-3) in scripts/linattn_seed_loop.py's loop over
    # generator seeds 0-255 (see the tolerances below)
    (2, 4, 333, 64, "mixed:30"), (2, 4, 333, 64, "mixed:7"),
    (2, 4, 333, 64, "mixed:31"), (1, 3, 130, 128, "mixed:51"),
    (1, 3, 130, 128, "mixed:102"),
]


def _mixed_seed(S, K, logw):
    """The CUDA generator's seed of a mixed case, or ``None``."""
    if not (isinstance(logw, str) and logw.startswith("mixed")):
        return None
    return S + K if logw == "mixed" else int(logw.split(":")[1])


def _sm90_case_inputs(B, H, S, K, logw):
    """bf16 r, k, v and f32 logw, u of one LINATTN_SM90_CASES case."""
    rng = np.random.default_rng(S + K)
    seed = _mixed_seed(S, K, logw)
    r, k, v, lw, u = _linattn_inputs(rng, B, H, S, K, torch.bfloat16,
                                     logw=None if seed is not None else logw)
    if seed is not None:
        scale = np.exp(rng.uniform(np.log(1e-6), np.log(30.0), K))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        lw = torch.from_numpy(-scale.astype(np.float32)).cuda() * torch.exp(
            0.3 * torch.randn((B, H, S, K), device="cuda", generator=gen))
    return r, k, v, lw, u


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,K,logw", LINATTN_SM90_CASES)
def test_linattn_sm90_kernel_matches_plain_on_card(B, H, S, K, logw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.linattn_scan import ops as lops
    from repro_torch.kernels.linattn_scan.ref import linattn_reference
    r, k, v, lw, u = _sm90_case_inputs(B, H, S, K, logw)
    for logw_t in (lw, lw.to(torch.bfloat16)):
        lops.reset_launches()
        got = lops.linattn(r, k, v, logw_t, u, return_state=True)
        assert lops.linattn.launches_by_route == {"sm90_bf16": 1,
                                                  "cuda_core": 0}
        want = linattn_reference(r, k, v, logw_t, u)
        torch.cuda.synchronize()
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
        ey, es = _linattn_errs(got, want)
        assert ey < 5e-2 and es < 1e-4, ((B, H, S, K, logw), ey, es)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,K,logw", [c for c in LINATTN_SM90_CASES
                                          if _mixed_seed(*c[2:4], c[4])
                                          is not None])
def test_linattn_sm90_kernel_is_deterministic_on_card(B, H, S, K, logw):
    """Two calls on one input give equal tensors, so a case's errors are a
    function of its inputs alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.linattn_scan import ops as lops
    r, k, v, lw, u = _sm90_case_inputs(B, H, S, K, logw)
    assert torch.equal(lw, _sm90_case_inputs(B, H, S, K, logw)[3])
    for logw_t in (lw, lw.to(torch.bfloat16)):
        a = lops.linattn(r, k, v, logw_t, u, return_state=True)
        b = lops.linattn(r, k, v, logw_t, u, return_state=True)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# The kernel against ref.py::linattn_sm90_reference, the statement of its
# arithmetic that the CPU tests hold to JAX.  The statement rounds where the
# kernel rounds, so the two part only where an f32 value differs (summation
# order; ex2.approx against exp2, ~2^-22) and that flips a rounding: y's
# own bf16 rounding (one ulp of the entry, set aside), or an operand's
# (2^-8 of one operand, times the other).  The second is not rare: over
# generator seeds 0-255 of the two mixed cases (1,024 calls, f32 and bf16
# logw), 48 calls left 1e-3 of y's largest entry beyond the ulp, the worst
# at 1.82e-3, every one through y's largest error alone (RMS <= 2.7e-4,
# state <= 3.7e-6).  The kernel is no farther from a float64 scan than its
# statement (y RMS ratio 0.99916-1.00047, y's largest error within 6.8e-4
# of the statement's; both ~2.7e-3 RMS from it) and two calls on one input
# are equal, so the flips are the statement's rounding against the
# kernel's, not a fault of either: y within 2^-8 (one flip of a unit term)
# of its largest entry beyond that ulp, and within 1e-3 in RMS, which a
# systematic error (~3e-3 RMS against the exact scan) would leave.  The
# state is f32 but for the hi/lo split, whose flipped lo rounding costs
# 2^-16 of one term: within 1e-5 of its largest entry, where kw rounded to
# bf16 once (no lo product) costs 2^-9 a term.
STATEMENT_Y_TOL, STATEMENT_Y_RMS_TOL = 2.0**-8, 1e-3
STATEMENT_STATE_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,K,logw", LINATTN_SM90_CASES)
def test_linattn_sm90_kernel_matches_its_statement_on_card(B, H, S, K, logw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.linattn_scan import ops as lops
    from repro_torch.kernels.linattn_scan.ref import (
        linattn_sm90_reference, sm90_statement_errs)
    r, k, v, lw, u = _sm90_case_inputs(B, H, S, K, logw)
    for logw_t in (lw, lw.to(torch.bfloat16)):
        got = lops.linattn(r, k, v, logw_t, u, return_state=True)
        want = linattn_sm90_reference(*(x.cpu() for x in (r, k, v, logw_t, u)))
        ey, rms, es = sm90_statement_errs(got, want)
        assert (ey < STATEMENT_Y_TOL and rms < STATEMENT_Y_RMS_TOL
                and es < STATEMENT_STATE_TOL), ((B, H, S, K, logw), ey, rms, es)


def scan64(r, k, v, logw, u):
    """The RWKV6 recurrence token by token in float64 on the CPU:
    ``(y, state)`` as ``linattn_reference`` returns them, unrounded."""
    rf, kf, vf, lw = (a.cpu().double() for a in (r, k, v, logw))
    B, H, S, K = rf.shape
    w = torch.exp(lw)
    uf = u.cpu().double()[None, :, :, None]
    state = torch.zeros((B, H, K, K), dtype=torch.float64)
    ys = []
    for t in range(S):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], state + uf * kv))
        state = w[:, :, t, :, None] * state + kv
    return torch.stack(ys, dim=2), state


def errs64(got, want) -> dict:
    """y's largest error over its largest entry, y's RMS error over its
    RMS, and the state's largest error over its largest entry, of ``got``
    against :func:`scan64`'s ``want``."""
    y, s = got[0].cpu().double(), got[1].cpu().double()
    wy, ws = want
    return {"y_max": float((y - wy).abs().max() / wy.abs().max()),
            "y_rms": float((y - wy).square().mean().sqrt()
                           / wy.square().mean().sqrt()),
            "state_max": float((s - ws).abs().max() / ws.abs().max())}


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,K,logw", [c for c in LINATTN_SM90_CASES
                                          if _mixed_seed(*c[2:4], c[4])
                                          is not None])
def test_linattn_sm90_kernel_as_close_to_f64_as_its_statement_on_card(
        B, H, S, K, logw):
    """Against a float64 scan the kernel's y is as close as its statement's
    in RMS (within 1%; the seed loop saw 0.99916-1.00047 of it), and its
    state within 1e-5 of the largest entry, as the statement's is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.linattn_scan import ops as lops
    from repro_torch.kernels.linattn_scan.ref import linattn_sm90_reference
    r, k, v, lw, u = _sm90_case_inputs(B, H, S, K, logw)
    for logw_t in (lw, lw.to(torch.bfloat16)):
        cpu = [x.cpu() for x in (r, k, v, logw_t, u)]
        exact = scan64(*cpu)
        kern = errs64(lops.linattn(r, k, v, logw_t, u, return_state=True),
                      exact)
        stmt = errs64(linattn_sm90_reference(*cpu), exact)
        assert kern["y_rms"] <= 1.01 * stmt["y_rms"], (logw, kern, stmt)
        assert kern["state_max"] < STATEMENT_STATE_TOL, (logw, kern, stmt)
        assert stmt["state_max"] < STATEMENT_STATE_TOL, (logw, kern, stmt)


@pytest.mark.cuda
def test_linattn_routes_by_dtype_and_key_dim_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.linattn_scan import ops as lops
    rng = np.random.default_rng(3)
    lops.reset_launches()
    for dt, K in ((torch.bfloat16, 64), (torch.bfloat16, 128),
                  (torch.bfloat16, 32), (torch.float32, 64)):
        lops.linattn(*_linattn_inputs(rng, 1, 2, 70, K, dt))
    assert lops.linattn.launches_by_route == {"sm90_bf16": 2, "cuda_core": 2}
    assert lops.linattn.launches == 4
    # the model's layout is read in place by TMA, and gives the same answer
    args = _linattn_inputs(rng, 2, 3, 90, 64, torch.bfloat16)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in args[:4]]
    a = lops.linattn(*args, return_state=True)
    b = lops.linattn(*views, args[4], return_state=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # what TMA cannot take raises, and launches nothing
    flat = torch.zeros(2 * 3 * 90 * 64 + 1, device="cuda", dtype=torch.bfloat16)
    odd = flat[1:].view(2, 3, 90, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lops.linattn(odd, *args[1:])
    assert lops.linattn.launches == 6
    lops.reset_launches()
