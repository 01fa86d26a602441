#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time:

1. env     - the card (name and power limit from nvidia-smi), torch and
             CUDA versions; the compute capability must be (9, 0).
2. build   - every CUDA kernel of the port, compiled from the sources in
             this checkout with nvcc (one process per source, in parallel).
3. kernel  - queue_select on the card against its plain PyTorch version,
             bit for bit, over sizes, feasibility rates, negative scores,
             ties and the feasible-BIG corner; then its time (median of
             CUDA-event-timed launches) beside the plain version, a
             two-call PyTorch yardstick and the memory-bandwidth bound.
4. golden  - the engine on cuda, 10,000-job SDSC-SP2-like (six policies)
             and DAS-2-like (fcfs, backfill) traces, each held to the JAX
             engine's n_events, makespan and start/finish digests in
             tests/data/torch_port_golden.json; events/s per run.
5. archive - backfill over 73,496 SDSC-SP2-like jobs on 128 nodes (the
             SDSC-SP2 log's job count on its machine), checked for
             completion, start >= submit, finish == start + runtime and a
             busy-node count that never exceeds the machine.
6. profile - the card's busy share of a short backfill run.
7. flash   - flash_attention on the card against its plain PyTorch
             version over the CPU tests' shape grid plus head dims 80 and
             128 and the serve shape, f32 and bf16, causal, windowed and
             full; then its time at the serve shape beside the plain
             version, F.scaled_dot_product_attention (the library
             yardstick, never called by the port) and the compute bound.
8. lm_golden - reduced llama3.2-3b in f32 on the kernel path, held to the
             JAX package's prefill logits and generated tokens in
             tests/data/torch_lm_golden.json.
9. serve   - llama3.2-3b at full width and depth: (a) an f32 prefill of
             one 512-token prompt on the kernel path against the plain
             (blockwise) path, with the attention projections drawn at
             their true fan-in (see fan_in_attention); (b) the bf16 serve
             of 4 prompts of 2,048 tokens plus 32 generated tokens each,
             through serve_batch, which must launch the kernel once per
             layer (28); then one profiled prefill and one profiled
             decode step, each with the top device operations, the card's
             busy share and the kernel's share of device time.

Each kernel's launch counter is set to 0 before each run of its main path
(phases 4 and 5 for queue_select, the serve of phase 9 for flash_attention)
and read after it; a run that did not launch the kernel fails.  TF32 is
off for matrix products and convolutions throughout.  The script catches
nothing: any failed check exits non-zero.  The last lines are the kernels
table, the nvidia-smi line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.json"
LM_GOLDEN = ROOT / "tests" / "data" / "torch_lm_golden.json"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
BIG = 2**30 - 1
TIMED_LAUNCHES = 200
ARCHIVE_JOBS = 73_496            # SDSC-SP2 log's job count
ARCHIVE_NODES = 128
PROFILE_JOBS = 250
# flash_attention grid: (B, Sq, Sk, H, KV, hd), the CPU sweep's shapes
# plus the models' head dims and the serve shape
FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64), (1, 128, 384, 8, 8, 128), (2, 200, 200, 4, 1, 64),
    (1, 1, 256, 8, 2, 64), (2, 64, 512, 4, 4, 32), (2, 160, 160, 8, 2, 80),
    (1, 300, 300, 24, 8, 128), (2, 96, 352, 32, 8, 80),
    (4, 2048, 2048, 24, 8, 128),
]
FLASH_MASKS = [(True, None), (True, 96), (False, None)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # as tests/test_kernels.py
FLASH_TIMED = 50
SERVE = {"batch": 4, "prompt_len": 2048, "gen": 32}
CHECK_LEN = 512                  # phase 9a's prompt
LM_TOL = 5e-4                    # f32 logits, see tests/test_torch_lm.py
CHECK_TOL = 1e-4                 # phase 9a, f32, kernel vs plain path


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3),
                      **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a, dtype="<i4").tobytes()
                          ).hexdigest()


def time_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Median of ``n`` calls, each timed with a CUDA event pair."""
    import torch
    for _ in range(10):
        fn()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_events(prof) -> dict:
    """``{name: (count, total_us)}`` over the device-side events (kernels,
    copies, memsets) of a torch.profiler run.  Host-side ops are left out:
    their device time repeats that of the kernels they launched."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return out


def profiled(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t) * 1e6
    return device_events(prof), wall_us


def phase_kernel(torch, np, ops, ref):
    t0 = time.time()
    rng = np.random.default_rng(0)
    dev = "cuda"
    n_checks, max_err = 0, 0

    def compare(scores, feas):
        nonlocal n_checks, max_err
        s = torch.from_numpy(scores).to(dev)
        for mask in (torch.from_numpy(feas).to(dev),
                     torch.from_numpy(feas.astype(np.int32)).to(dev)):
            got = ops.queue_select(s, mask)
            want = ref.queue_select_reference(s, mask)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            check(err == 0, f"queue_select N={scores.size} "
                  f"mask={mask.dtype}: {got.tolist()} != {want.tolist()}")
            max_err = max(max_err, err)
            n_checks += 1

    for n in (7, 1000, 10_000, ARCHIVE_JOBS, 1_048_576):
        for rate in (0.0, 0.05, 0.5, 1.0):
            feas = rng.random(n) < rate
            # negative scores and many ties: 2,001 distinct values
            compare(rng.integers(-1000, 1001, n).astype(np.int32), feas)
            big = np.full(n, BIG, np.int32)   # feasible entries scoring BIG
            compare(big, feas)
    compare(np.array([-5], np.int32), np.array([True]))
    compare(np.array([3], np.int32), np.array([False]))

    # timing at the archive run's shape: N rows, bool mask, half feasible
    n = ARCHIVE_JOBS
    s = torch.from_numpy(rng.integers(0, 10**6, n).astype(np.int32)).to(dev)
    m = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    # (score, index) packed so that int64 order is lexicographic order
    key = (s.to(torch.int64) << 32) | torch.arange(n, device=dev)
    sentinel = torch.iinfo(torch.int64).max
    kernel_ms = time_ms(lambda: ops.queue_select(s, m))
    plain_ms = time_ms(lambda: ref.queue_select_reference(s, m))
    library_ms = time_ms(lambda: torch.min(torch.where(m, key, sentinel)))
    calls = 100
    dev, _ = profiled(torch, lambda: [ops.queue_select(s, m)
                                      for _ in range(calls)])
    reduce_us = [us / k for name, (k, us) in dev.items()
                 if "select_reduce" in name]
    device_us = sum(us for _, us in dev.values()) / calls
    bytes_moved = n * (4 + 1) + 2 * 4     # scores + bool mask read, i32[2]
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops.queue_select.launches = 0
    timing = {"n": n, "mask": "bool", "kernel_ms": kernel_ms,
              "device_us_per_call": device_us if dev else "not measured",
              "reduce_device_us": reduce_us[0] if reduce_us
              else "not measured",
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library_call": "torch.min(torch.where(feasible, packed_key, "
                              "INT64_MAX)): two calls, packed key built "
                              "outside the timing",
              "bytes": bytes_moved, "bound_ms": bound_ms,
              "bound_us": bound_ms * 1e3}
    emit("kernel", t0, checks=n_checks, max_abs_err=max_err, **timing)
    return max_err, timing


def run_counted(rt, ops, scn):
    """One engine run on cuda with the kernel's launch count around it."""
    import torch
    ops.queue_select.launches = 0
    t = time.time()
    res = rt.run(scn, device="cuda")
    out = res.to_np()
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = ops.queue_select.launches
    check(launches > 0, f"{scn.policy} run launched no queue_select kernel")
    return out, wall, launches


def phase_golden(rt, ops):
    t0 = time.time()
    entries = json.loads(GOLDEN.read_text())["runs"]
    launches = 0
    for e in entries:
        scn = rt.Scenario(
            trace=rt.SyntheticTrace(n_jobs=e["n_jobs"], seed=e["seed"],
                                    kind=e["kind"]),
            total_nodes=e["total_nodes"], policy=e["policy"])
        out, wall, n = run_counted(rt, ops, scn)
        launches += n
        v = out["valid"]
        got = {"n_events": out["n_events"], "makespan": out["makespan"],
               "start_sha256": digest(out["start"][v]),
               "finish_sha256": digest(out["finish"][v])}
        for k, want in got.items():
            check(want == e[k], f"{e['kind']}/{e['policy']}: {k} {want} "
                  f"!= golden {e[k]}")
        emit("golden", t0, kind=e["kind"], policy=e["policy"],
             n_jobs=e["n_jobs"], total_nodes=e["total_nodes"],
             n_events=out["n_events"], run_seconds=wall,
             events_per_s=out["n_events"] / wall, launches=n,
             matches_jax=True)
    return launches


def phase_archive(rt, ops, np):
    t0 = time.time()
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=ARCHIVE_JOBS, seed=1,
                                              kind="sdsc_sp2"),
                      total_nodes=ARCHIVE_NODES, policy="backfill")
    out, wall, launches = run_counted(rt, ops, scn)
    v = out["valid"]
    sub, st, fin, run, nodes = (out[k][v].astype(np.int64) for k in
                                ("submit", "start", "finish", "runtime",
                                 "nodes"))
    check(bool(out["done"][v].all()), "archive run left jobs unfinished")
    check(bool((st >= sub).all()), "a job started before its submit")
    check(bool((fin == st + run).all()), "finish != start + runtime")
    # busy-node sweep: releases sort before starts at the same instant
    t = np.concatenate([fin, st])
    d = np.concatenate([-nodes, nodes])
    order = np.lexsort((d, t))
    peak = int(np.cumsum(d[order]).max())
    check(peak <= ARCHIVE_NODES, f"busy nodes peaked at {peak}")
    emit("archive", t0, policy="backfill", n_jobs=int(v.sum()),
         total_nodes=ARCHIVE_NODES, n_events=out["n_events"],
         run_seconds=wall, events_per_s=out["n_events"] / wall,
         makespan=out["makespan"], peak_busy_nodes=peak, launches=launches)
    return launches


def phase_profile(torch, rt):
    """One short backfill run under torch.profiler: the card's busy share
    of the run's wall time (which the profiler itself lengthens).  Kept
    short because the profiler's post-processing grows with the op
    count."""
    t0 = time.time()
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=PROFILE_JOBS, seed=1,
                                              kind="sdsc_sp2"),
                      total_nodes=ARCHIVE_NODES, policy="backfill")
    dev, wall_us = profiled(torch, lambda: rt.run(scn, device="cuda").to_np())
    busy_us = sum(us for _, us in dev.values())
    top = sorted(dev.items(), key=lambda kv: kv[1][1], reverse=True)[:5]
    emit("profile", t0, n_jobs=PROFILE_JOBS, policy="backfill",
         wall_s=wall_us / 1e6, device_busy_s=busy_us / 1e6,
         device_busy_share=busy_us / wall_us if dev else "not measured",
         device_events=sum(k for k, _ in dev.values()),
         top_device_us={name[:60]: us for name, (_, us) in top})


def phase_flash(torch, np):
    from repro_torch.kernels.flash_attention import ops, ref
    t0 = time.time()
    rng = np.random.default_rng(0)
    n_checks, max_err = 0, dict.fromkeys(FLASH_TOL, 0.0)
    for B, Sq, Sk, H, KV, hd in FLASH_SHAPES:
        base = [rng.standard_normal((B, s, n, hd), dtype=np.float32)
                for s, n in ((Sq, H), (Sk, KV), (Sk, KV))]
        for dtype, tol in FLASH_TOL.items():
            q, k, v = (torch.from_numpy(a).to("cuda", getattr(torch, dtype))
                       for a in base)
            for causal, window in FLASH_MASKS:
                kw = dict(causal=causal, window=window, q_offset=Sk - Sq)
                got = ops.flash_attention(q, k, v, **kw)
                want = ref.attention_reference(q, k, v, **kw).float()
                d = (got.float() - want).abs()
                bad = int((d > tol + tol * want.abs()).sum())
                check(bad == 0 and got.dtype == q.dtype,
                      f"flash_attention {dtype} {(B, Sq, Sk, H, KV, hd)} "
                      f"{kw}: {bad} entries off by up to {float(d.max())}")
                max_err[dtype] = max(max_err[dtype], float(d.max()))
                n_checks += 1
    del q, k, v, got, want, d

    # timing at the serve shape: bf16, causal, every layer's prefill call
    B, S, H, KV, hd = (SERVE["batch"], SERVE["prompt_len"], 24, 8, 128)
    q, k, v = (torch.randn((B, S, n, hd), device="cuda", dtype=torch.bfloat16)
               for n in (H, KV, KV))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # [B, heads, S, hd]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                        FLASH_TIMED)
    plain_ms = time_ms(lambda: ref.attention_reference(q, k, v, causal=True),
                       FLASH_TIMED)
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True), FLASH_TIMED)
    # 4 hd flops (q.k and p.v) for each (query, key) pair the causal mask
    # leaves: S (S + 1) / 2 of them for each (batch, head)
    flops = 4 * hd * B * H * (S * (S + 1) // 2)
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    ops_ms, bytes_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    ops.flash_attention.launches = 0
    timing = {"shape": f"B={B} Sq=Sk={S} H={H} KV={KV} hd={hd} bf16 causal",
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "library_call": "F.scaled_dot_product_attention(is_causal=True, "
                              "enable_gqa=True) on [B, heads, S, hd] views",
              "flops": flops, "bytes": nbytes,
              "bound_ms": max(ops_ms, bytes_ms),
              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
              "tflops": flops / kernel_ms / 1e9}
    emit("flash", t0, checks=n_checks, tf32=False,
         max_abs_err_f32=max_err["float32"],
         max_abs_err_bf16=max_err["bfloat16"], **timing)
    return max(max_err.values()), timing


def phase_lm_golden(torch, np):
    """Reduced llama3.2-3b, f32, on the kernel path: the JAX package's
    prefill logits and generated tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm
    t0 = time.time()
    g = json.loads(LM_GOLDEN.read_text())
    cfg = dataclasses.replace(get_config(g["arch"]).reduced(), use_pallas=True)
    params = lm_params_from_numpy(numpy_lm_params(cfg, g["seed"]), "cuda")
    before = ops.flash_attention.launches
    last, _ = lm.prefill(
        params, {"tokens": torch.tensor(g["prompts"], device="cuda")}, cfg)
    check(ops.flash_attention.launches == before + cfg.n_layers,
          "the golden prefill did not run the kernel in every layer")
    last = last.cpu().numpy()
    err = float(np.abs(last - np.asarray(g["last_logits"])).max())
    check(np.allclose(last, g["last_logits"], atol=LM_TOL, rtol=LM_TOL),
          f"golden prefill logits off by {err}")
    seqs, _ = serve_batch(cfg, g["batch"], g["prompt_len"], g["gen"],
                          seed=g["seed"], params=params, device="cuda")
    check(seqs.tolist() == g["tokens"], "golden tokens differ from JAX's")
    ops.flash_attention.launches = 0
    emit("lm_golden", t0, arch=g["arch"], reduced=True, dtype=cfg.dtype,
         batch=g["batch"], prompt_len=g["prompt_len"], gen=g["gen"],
         max_abs_err=err, tol=LM_TOL, tokens_equal_jax=True)


def fan_in_attention(params, cfg) -> None:
    """Scale a freshly initialized LM's attention projections to their true
    fan-in: std d_model^-0.5 for wq/wk/wv, (H hd)^-0.5 for wo.  The JAX
    package's initializer, which the port keeps, takes the fan-in from the
    heads axis; a 28-layer random model drawn so is chaotic (a change of the
    blockwise path's tile size alone moves its logits by more than 0.1), so
    no two f32 implementations of it agree at the end.  With these scales
    they agree within 1e-4 (tests/test_torch_lm.py::
    test_deep_random_model_is_chaotic_unless_fan_in_scaled, at width 256)."""
    a = params.tree()["blocks"]["attn"]
    for n in ("wq", "wk", "wv"):          # [L, D, heads, hd]
        a[n].mul_((a[n].shape[2] / cfg.d_model) ** 0.5)
    a["wo"].mul_(a["wo"].shape[1] ** -0.5)  # [L, H, hd, D]


def phase_serve(torch, np):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm
    from repro_torch.models.api import get_model
    from repro_torch.sharding.rules import map_defs
    t0 = time.time()
    base = get_config("llama3.2-3b")
    model = get_model(base)

    # (a) f32 at full width: the kernel path against the blockwise path
    cfg32 = dataclasses.replace(base, dtype="float32", use_pallas=True)
    params = model.init(torch.Generator("cuda").manual_seed(1))
    fan_in_attention(params, base)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, base.vocab - 1, (1, CHECK_LEN))).to("cuda")
    got, _ = lm.prefill(params, {"tokens": toks}, cfg32)
    want, _ = lm.prefill(params, {"tokens": toks},
                         dataclasses.replace(cfg32, use_pallas=False))
    got, want = got.cpu().numpy(), want.cpu().numpy()
    err = float(np.abs(got - want).max())
    check(bool(np.isfinite(got).all()) and got.shape == (1, base.vocab),
          "full-width f32 prefill logits not finite or misshapen")
    check(np.allclose(got, want, atol=CHECK_TOL, rtol=CHECK_TOL),
          f"full-width f32 prefill: kernel path off the plain path by {err}")
    emit("serve_check", t0, arch=base.name, dtype="float32",
         prompt_len=CHECK_LEN, max_abs_err=err, tol=CHECK_TOL,
         max_abs_logit=float(np.abs(want).max()),
         argmax_equal=bool((got.argmax(-1) == want.argmax(-1)).all()))
    del params
    torch.cuda.empty_cache()

    # (b) the bf16 serve through serve_batch, twice (cold, then warm)
    t0 = time.time()
    cfg = dataclasses.replace(base, use_pallas=True)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    prompts = np.random.default_rng(0).integers(
        1, base.vocab - 1, (SERVE["batch"], SERVE["prompt_len"]))
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        ops.flash_attention.launches = 0
        seqs, stats = serve_batch(cfg, **SERVE, seed=0, params=params,
                                  device="cuda")
        launches = ops.flash_attention.launches
        check(launches == base.n_layers,
              f"serve launched flash_attention {launches} times, "
              f"expected {base.n_layers}")
        out = seqs.cpu().numpy()
        total = SERVE["prompt_len"] + SERVE["gen"]
        check(out.shape == (SERVE["batch"], total)
              and (out[:, :SERVE["prompt_len"]] == prompts).all()
              and ((out >= 0) & (out < base.vocab)).all(),
              "serve returned malformed sequences")
        emit("serve", t0, run=run, arch=base.name, dtype=cfg.dtype,
             **SERVE, n_params=model.n_params(), flash_launches=launches,
             prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
             decode_tok_per_s=stats["decode_tok_per_s"],
             total_tok_per_s=stats["tok_per_s"], seconds=stats["seconds"],
             prefill_tok_per_s=SERVE["batch"] * SERVE["prompt_len"]
             / stats["prefill_s"],
             max_memory_allocated=torch.cuda.max_memory_allocated())

    # one profiled prefill and one profiled decode step: top device
    # operations, the device's busy share, the kernel's share
    batch = {"tokens": torch.from_numpy(prompts).to("cuda")}
    total = SERVE["prompt_len"] + SERVE["gen"]
    cache = map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                           device="cuda"),
                     model.cache_defs_fn(SERVE["batch"], total))
    tok = seqs[:, SERVE["prompt_len"]]
    step = lambda: lm.decode_step(params, tok, SERVE["prompt_len"], cache, cfg)  # noqa: E731
    step()                                     # warm
    for name, fn in (("prefill", lambda: lm.prefill(params, batch, cfg)),
                     ("decode_step", step)):
        t0 = time.time()
        dev, wall_us = profiled(torch, fn)
        busy_us = sum(us for _, us in dev.values())
        flash_us = sum(us for n, (_, us) in dev.items() if "flash_fwd" in n)
        top = sorted(dev.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
        emit("serve_profile", t0, what=name, wall_s=wall_us / 1e6,
             device_busy_s=busy_us / 1e6,
             device_busy_share=busy_us / wall_us if dev else "not measured",
             device_events=sum(k for k, _ in dev.values()),
             flash_device_s=flash_us / 1e6,
             flash_share_of_device=flash_us / busy_us if dev
             else "not measured",
             top_device_us={n[:60]: us for n, (_, us) in top})
    ops.flash_attention.launches = 0
    return launches


def main() -> int:
    t_all = time.time()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not ((ROOT / "src" / "repro_torch").is_dir() and GOLDEN.exists()
            and LM_GOLDEN.exists()):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch and tests/data are missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    import repro_torch as rt
    from repro_torch.kernels import _build
    from repro_torch.kernels.queue_select import ops, ref

    t0 = time.time()
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    emit("env", t0, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, capability=list(cap),
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0)")

    t0 = time.time()
    logs = _build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", t0, sources=list(logs), ptxas=ptxas)

    max_err, timing = phase_kernel(torch, np, ops, ref)
    launches = phase_golden(rt, ops) + phase_archive(rt, ops, np)
    phase_profile(torch, rt)
    flash_err, flash = phase_flash(torch, np)
    phase_lm_golden(torch, np)
    flash_launches = phase_serve(torch, np)

    print(json.dumps({"kernels": [{
        "name": "queue_select",
        "route": "cuda",
        "source": "src/repro_torch/kernels/queue_select/csrc/queue_select.cu",
        "replaces": "src/repro/kernels/queue_select/kernel.py:23",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["kernel_ms"],
        "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_us": timing["bound_us"],
        "bound_by": "bytes",
        "library_ms": timing["library_ms"],
        "shape": f"N={timing['n']}, bool mask",
        "device_us_per_call": timing["device_us_per_call"],
        "reduce_device_us": timing["reduce_device_us"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
        "launches": flash_launches,
        "max_abs_err": flash_err,
        "ms": flash["kernel_ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "shape": flash["shape"],
        "flops": flash["flops"],
        "bytes": flash["bytes"],
    }]}), flush=True)
    emit("total", t_all)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
