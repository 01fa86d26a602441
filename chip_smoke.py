#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time:

1. env     - the card (name and power limit from nvidia-smi), torch and
             CUDA versions; the compute capability must be (9, 0).
2. build   - every CUDA kernel of the port, compiled from the sources in
             this checkout with nvcc (one process per source, in parallel);
             ptxas's registers and spills per source, the sm90 flash
             kernel's dynamic shared memory per head dim and the sm90
             linattn kernel's per key dim.
3. kernel  - queue_select on the card against its plain PyTorch version,
             bit for bit: the generic op (scores and mask given) over sizes,
             feasibility rates, negative scores, ties and the feasible-BIG
             corner; every fused mode (key and mask built in the kernel)
             and the shadow walk over random job tables at N = 7, 1,000,
             8,191-8,193 (one cluster's threads) and 73,496, and the
             modes that read the node column and the walk once more over a
             per-call width column (a malleable run's), which must change
             some answers.  Then, at N =
             73,496, each one's time: the generic op CUDA-event-timed beside
             its plain version, a two-call PyTorch yardstick and its bound;
             each fused mode and the walk by the host clock around the call
             (which returns only once the answer is in host memory) beside
             its plain version and the bound of the columns it reads; and
             the device operations per call from the profiler (one; a
             short count, which a dropped profiler event gives, is profiled
             again once before it fails).
3b. batched - the batched entries (queue_select_fused_batch and
             queue_select_walk_batch: one launch answers one request for
             each of several ensemble members) against their plain versions
             and the solo kernel on each member's row, bit for bit: phase
             3's random tables stacked six at a time over its sizes, each
             launch with idle members and mixed modes.  Then, at B = 8 and
             16 members of 10,000 rows, a launch's time by the host clock
             (backfill_cand for every member, or a 4-release walk) beside
             the batched plain version and the bound (B x J x the mode's
             bytes a row), and its device operations (two: the requests'
             upload and the kernel).  Then the batched generic entry
             (queue_select_batch: the batched pool engine's selections)
             against its plain version and the solo generic op on each
             row, at B = 8, 24 and 32 members of T = 165 and 2,625
             entries; at B x T = 24 x 2,625 and 32 x 165 a launch's time by
             the host clock beside the plain version, the two-call PyTorch
             form and the bound (B x T x 5 bytes), and its device
             operations (two).
4. golden  - the engine on cuda, 10,000-job SDSC-SP2-like (six policies)
             and DAS-2-like (fcfs, backfill) traces, each held to the JAX
             engine's n_events, makespan and start/finish digests in
             tests/data/torch_port_golden.json; per run events/s,
             queue_select and walk launches, launches per event, and the
             batched backfill pass's redo walks; a backfill run must
             launch the walk, at most once an event besides its redos.
5. archive - backfill over 9,187 SDSC-SP2-like jobs on 128 nodes (an
             eighth of the SDSC-SP2 log's job count on its machine: the
             whole log's 73,496 until the alloc phases came, half until
             the malleable ones, a quarter until the oracle), checked for
             completion, start >= submit, finish == start + runtime and a
             busy-node count that never exceeds the machine; the counts of
             phase 4.
6. profile - the card's busy share of a short backfill run.
6b. sweep  - Fig. 4(b)'s grid through sweep: 10,000 SDSC-SP2-like jobs,
             the six policies on 128 and 256 nodes, one bucket of 12
             members in lockstep; the 128-node members held to the golden
             digests, the 256-node backfill member to its solo run on the
             card (all six until the alloc phases came, preempt too until
             the oracle came); then
             DAS-2-like seed 0 on 400 nodes over fcfs and backfill, held to
             its digests.  n_compiles, wall seconds, aggregate events/s,
             batched launches and the member-selections a launch served.
6c. ensemble - Fig. 5(a)'s shape: DAS-2-like backfill on 400 nodes,
             2,500 jobs (10,000 until the oracle came, 5,000 until the
             window phases; phase 4 and phase 6b's das2 members hold the
             10,000-job seed 0 to its digest),
             trace seeds 0-7 as one batch of 8 and as a serial loop of
             run, member by member equal; events/s both ways and their
             ratio; B = 1 through
             sweep against the solo run (the lockstep driver's own cost);
             the card's busy share of a profiled 250-job batch of 8.
6d. alloc  - topology-aware allocation at 1,250 jobs (1.25x
             fig_alloc.py's 1,000; 10,000 until the malleable phases
             came, 5,000 until the oracle, 2,500 until the window phases,
             PERF.md section 4), each run held to
             the JAX engine's n_events, makespan and digests of start,
             finish, alloc_first, alloc_span, alloc_sum and the ev_lfb log
             (tests/data/torch_alloc_golden.json): Fig. alloc's grid
             (SDSC-SP2-like seed 1 on dragonfly(16, 8), backfill x simple,
             contiguous, spread, topo, contention off; the runs with
             contention (1, 5) meet theirs in phase 6e, cut to fit the DAG
             phases); the
             per-start loop on DAS-2's 400 nodes as mesh2d(20, 20)
             (fcfs/topo, sjf/spread, bestfit/contiguous); preempt under
             contiguous on the SDSC-SP2 machine, which reaches the
             fallback to simple.  Per run events/s, selections, walks,
             launches an event and the largest-free-run reads an event;
             beside them the scalar-mode SDSC-SP2 backfill run of the
             same 1,250 jobs (phase 4's run when the sizes agree), and the
             busy
             share and device operations an event of a profiled 250-job
             run.  queue_select must launch on every run, the walk on
             every backfill run.
6e. alloc_sweep - Fig. alloc's grid through sweep: one bucket of 8
             members in lockstep, each held to its solo run's digests;
             n_compiles, events/s against phase 6d's four solo runs of
             the grid, batched launches and member-selections a launch.
6f. dag    - a workflow DAG on the cluster: galactic_like(256, 12, seed=0),
             10,497 tasks and 18,944 edges, the six policies in scalar mode
             on 128 nodes (preempt over critical-path priorities), then
             backfill/topo, fcfs/contiguous and sjf/simple on
             dragonfly(16, 8) with contention (1, 5); each run held to the
             JAX engine's n_events, makespan and digests of start, finish
             and ready (on the machine also the fingerprints and ev_lfb;
             tests/data/torch_dag_golden.json).  Per run events/s, jobs/s,
             jobs an event, selections, walks and launches an event;
             beside them phase 4's scalar sdsc fcfs run of this call.
             FCFS, SJF and LJF under the free counter's cap take the
             prefix pass and must make no selection; every other run must
             launch queue_select.
6g. dag_sweep - fig_workflow_cluster.py's grid at that scale through
             sweep: fcfs, sjf, backfill, bestfit x simple, contiguous,
             topo on dragonfly(16, 8) with contention (1, 5), one bucket
             of 12 members, each held to its digests
             (tests/data/torch_dag_sweep_golden.json); events/s against
             the twelve solo runs.  Then a seed axis with ragged edge
             lists (a random layered DAG of 5,000 tasks, 10,497 until the
             oracle came; seeds 0-1, 0-3 until the malleable phases came;
             backfill; 128 nodes) in one
             bucket, each member equal to its solo run.
6h. workflow - the standalone pool engine: Figs. 6 and 7's 24 runs
             (galactic_like tiles 2-64 on [64, 1 << 20], sipht_like widths
             10-60 on [8, 8192], fcfs, fcfs_fit, cpath), each held to the
             JAX pool engine's digests (tests/data/
             torch_workflow_golden.json), then galactic_like(256, 12)
             under fcfs_fit, checked by invariants (every task done, no
             start before a dependency's finish, no pool exceeded); tasks/s
             and queue_select launches a task, which must be > 0.
6h'. workflow_batch - the batched pool engine (simulate_workflow_ensemble,
             members in lockstep, one batched generic queue_select launch
             a selection sub-round): (a) phase 6h's 24 runs as one ragged
             batch padded to 2,625 tasks, every member held to its JAX
             digests, tasks/s beside the 24 solo runs; (b) Fig. 6's
             ensemble rows, W = 1, 8 and 32 copies of galactic_like(4,
             12, seed=9) under fcfs_fit on [64, 1 << 20], tasks/s beside a
             serial loop of W solo runs, every member equal to the solo
             card run and to the host oracle.  Batched launches,
             member-selections a launch, and the card's busy share (of
             (a)'s first 60 events, and of the W = 32 batch).
6i. reliability - node failures at fig_reliability.py's size, each run
             held to the JAX engine's digests (tests/data/
             torch_rel_golden.json: start, finish, ready, n_restarts,
             lost_work, aborted; on a machine the fingerprints and ev_lfb),
             every failure stream checked untruncated: 2,000 congested
             SDSC-SP2-like jobs on 128 nodes, backfill, MTBF 50,000 s over
             2^19 s, requeue and abort; phase 4's 10,000 jobs at MTBF
             400,000 s over 2^22 s; the requeue model on dragonfly(16, 8)
             under backfill/simple and fcfs/contiguous, and under preempt;
             Galactic Plane under fcfs with aborts (the prefix pass, no
             selection).  Per run events/s, jobs/s, the failures, repairs
             and ticks consumed, kills by kind, device reads a stream
             entry and launches an event.
6j. reliability_sweep - the figure's MTBF x kill-rule grid (12 members)
             and its checkpoint axis (4) through sweep, one bucket each,
             every member held to its digests; batch events/s beside the
             solo rate of the members phase 6i ran.
6k. serving - fig_serving.py's runs at full size (3,353 requests on 64
             nodes with the autoscaler: fcfs, sjf, fcfs without it,
             fcfs/simple and sjf/contiguous on mesh2d(8, 8), fcfs with
             failures composed), held to tests/data/
             torch_serving_golden.json (with slo_met, deadline, class_id
             and the capacity log); the counts of phase 6i.
6l. serving_sweep - the figure's 5 rates x fcfs/sjf x autoscaler on/off
             (20 members, one bucket), each held to its digests; batch
             events/s beside the solo rate of the members 6k ran.
6m. malleable - malleable jobs solo, each run held to the JAX engine's
             digests (tests/data/torch_mal_golden.json: start, finish,
             ready and every mal_* column; with failures n_restarts,
             lost_work, aborted; on a machine the fingerprints and
             ev_lfb): des_throughput.py's moldable model (Amdahl 0.1,
             widths 1-16) on 5,000 SDSC-SP2-like jobs (phase 4's trace
             generator, seed 1) under backfill and on
             sdsc_sp2_like(2000, seed=13) under backfill and fcfs;
             fig_malleable.py's elastic model (interval
             64, shrink 24, grow 4, step 4, 4,096 ticks) on that trace on
             mesh2d(8, 16) under backfill/contiguous and sjf/spread, and in
             scalar mode under backfill with phase 6i's requeue model
             (failure shrinks).  Per run events/s, jobs/s, resizes, device
             reads a resize tick, launches an event, and the card's busy
             share of the run's first 150 events, profiled.  Every run
             must launch queue_select, every elastic run resize.
6n. malleable_sweep - fig_malleable.py's full run through sweep: the
             400-job trace on 64 nodes, the rigid baselines (fcfs,
             backfill) and the moldable and elastic grids (Amdahl 0.05,
             0.2, 0.5 x fcfs, backfill), one sweep call and one bucket
             each (cache_stats), every member held to its digests and to
             its solo run on the card; batch events/s beside the solo
             runs'.
6o. oracle - card runs of rt.run held to the host oracle rt.run_ref,
             key by key (every per-job column it returns, n_events,
             makespan), on twelve runs of about 2,000 jobs without a
             digest, seeds 101-106: sdsc_sp2_like on 128 nodes under the
             six policies; DAS-2-like on mesh2d(20, 20), spread,
             contention (1, 5), backfill; a Galactic Plane DAG of 1,969
             tasks on 128 nodes under backfill and fcfs (the prefix pass,
             no selection); requeue failures at MTBF 50,000 s; a serving
             trace with the autoscaler; moldable jobs (Amdahl 0.1, widths
             1-16).  The oracle's host seconds beside each card run's.
6p. window - the conservative window step, solo: (a) phase 4's backfill
             run (sdsc_sp2_like(10000, seed=1), 128 nodes) as rounds of
             simulate_window of one simulated day each and a drain at
             INF_TIME, held to its golden digest; (b) phase 6f's scalar
             backfill run of the Galactic Plane DAG as rounds of 100 s
             (releases cross rounds), held to its digest.  No round may
             saturate.  Events/s beside the one-shot run's: phase 4's
             of this process for (a), one before and one after for (b)
             (the stop test's cost, paired in time); rounds; launches
             (equal to the one-shot run's).
6q. multicluster - DAS-2's five clusters (144, 64, 64, 64, 64), 2,000
             das2 jobs each (seeds 50-54), backfill, Multicluster(window
             =3600), the clusters stepped in lockstep: with migration and
             the mixed grid (the Galactic Plane DAG of 657 tasks on the
             first cluster: edges, imports and migration in one run), each
             held to its JAX digest (tests/data/
             torch_multicluster_golden.json: start, finish, valid, done,
             migrated, dropped, saturated, makespan); without migration,
             each cluster equal to its solo one-shot run (rt.run), the
             lockstep run timed against them.  Rounds, lockstep events,
             events/s, the exchanges' host seconds, batched launches and
             member-selections a launch.
6r. replay - half benchmarks/replay_smoke.py's smoke size (cut to fit
             the limit): a 10,000-job synthetic archive (the smoke's
             generator and arrival rate) through dump_swf and load_swf,
             replayed under backfill on 128 nodes at window 4,096 (every
             job done
             or aborted, peak_live <= window); then its 4,000-job prefix
             at window 512: a kill after round 2 and a resume identical to
             the straight replay, which equals the port's
             replay_reference.  Jobs/s, events/s, rounds, peak_live, the
             flags, the oracle's and the kill/resume seconds.
7. flash   - flash_attention on the card against its plain PyTorch
             version over the CPU tests' shape grid plus head dims 80 and
             128 and the serve shape, f32 (the CUDA-core kernel) and bf16
             (the tensor-core sm90 kernel), causal, windowed and full, and
             bf16 cases that stress the sm90 tiling: stablelm-3b's heads
             (hd 80), h2o-danube-1.8b's heads with its window of 4,096
             over 4,608 positions, and Sk = 2,049; each call counted on
             its dtype's route.  Then, at the serve shape, the sm90
             kernel's time beside the f32 kernel's (in f32), the plain
             version, F.scaled_dot_product_attention (the library
             yardstick, never called by the port) and the compute bound,
             and the sm90 kernel's time at the hd-80 shape.
8. lm_golden - reduced llama3.2-3b in f32 on the kernel path, held to the
             JAX package's prefill logits and generated tokens in
             tests/data/torch_lm_golden.json.
9. serve   - llama3.2-3b at full width and depth: (a) an f32 prefill of
             one 512-token prompt on the kernel path against the plain
             (blockwise) path, with the attention projections drawn at
             their true fan-in (see fan_in_attention); (b) the bf16 serve
             of 4 prompts of 2,048 tokens plus 32 generated tokens each,
             through serve_batch, which must launch the sm90 kernel once
             per layer (28) and the f32 kernel never; then one profiled
             prefill and one profiled decode step, each with the top
             device operations, the card's busy share and the kernel's
             share of device time.
10. linattn - linattn_scan on the card against its plain PyTorch version
             (a token scan), y and final state, over the CPU tests' shape
             grid in f32 and bf16, a steep-decay case, a slow-decay case
             of ragged length 2,045 and the serve shape, plus bf16 cases
             on the sm90 route: steep decays at K 64 and 128 and per-channel
             decays from -30 to -1e-6 a step; each call counted on its
             route (bf16 with K 64 or 128: the tensor-core sm90 kernel;
             the rest: the CUDA-core kernel).  Then, at the serve shape,
             the sm90 kernel's time beside the CUDA-core kernel's on the
             same bf16 inputs, the plain version and the bound (no PyTorch
             call computes WKV6, so no library time).
11. rwkv_golden - reduced rwkv6-7b in f32 on the kernel path, with its
             zero-init leaves drawn live, held to the JAX package's
             prefill logits and generated tokens (the rwkv entry of
             tests/data/torch_lm_golden.json).
12. rwkv_serve - rwkv6-7b at full width and depth, with live leaves
             (29.06 GB of f32 weights, after the llama weights are freed):
             (a) a prefill of one 512-token prompt on the kernel path
             against the plain wkv_chunked path, last-position logits and
             every layer's final WKV state, in f32 (the CUDA-core kernel)
             and in bf16 (the sm90 kernel); (b) the bf16 serve of 4 prompts
             of 2,048 tokens plus 32 generated tokens each through
             serve_batch, cold then warm, which must launch the sm90
             kernel once per layer (32) and the CUDA-core kernel never;
             then one profiled prefill and one profiled decode step, as in
             phase 9.

Each kernel's launch counter is set to 0 before each run of its main path
(phases 4, 5, 6d, 6f, 6h, 6i, 6k, 6m, 6o, 6p and 6r for queue_select and
its walk, phases 6b, 6c, 6e, 6g, 6j, 6l, 6n and 6q for their batched
entries, each batch
of phase 6h' for the batched generic entry, the serve
of phase 9 for flash_attention,
the serve of phase 12 for linattn_scan) and read after it; a run that did
not launch the kernel fails.  TF32 is off for matrix products and
convolutions throughout.  The script catches nothing: any failed check
exits non-zero.  The last lines are the kernels table, the nvidia-smi line
and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --only flash,serve

runs the env and build phases and the named ones alone (a rehearsal: it
prints neither the kernels table nor the ok line).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.json"
ALLOC_GOLDEN = ROOT / "tests" / "data" / "torch_alloc_golden.json"
LM_GOLDEN = ROOT / "tests" / "data" / "torch_lm_golden.json"
DAG_GOLDEN = ROOT / "tests" / "data" / "torch_dag_golden.json"
DAG_SWEEP_GOLDEN = ROOT / "tests" / "data" / "torch_dag_sweep_golden.json"
WORKFLOW_GOLDEN = ROOT / "tests" / "data" / "torch_workflow_golden.json"
REL_GOLDEN = ROOT / "tests" / "data" / "torch_rel_golden.json"
SERVING_GOLDEN = ROOT / "tests" / "data" / "torch_serving_golden.json"
MAL_GOLDEN = ROOT / "tests" / "data" / "torch_mal_golden.json"
MC_GOLDEN = ROOT / "tests" / "data" / "torch_multicluster_golden.json"
WINDOW_DAY = 86_400              # phase window (a): one simulated day
WINDOW_DAG = 100                 # phase window (b): ~35 rounds of the DAG
MC_NODES = (144, 64, 64, 64, 64)  # DAS-2's five clusters
MC_JOBS = 2_000
MC_WINDOW = 3_600
REPLAY_JOBS = 10_000             # half benchmarks/replay_smoke.py's smoke
REPLAY_PREFIX = 4_000
REPLAY_WINDOW = 4_096
REPLAY_PREFIX_WINDOW = 512
REPLAY_NODES = 128
MAL_PROFILE_EVENTS = 150         # each malleable run's profiled prefix
PROFILE_PAD_S = 0.02             # host-only time at each end of a profile
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                # H100 SXM f32 peak outside the tensor cores
BIG = 2**30 - 1
TIMED_LAUNCHES = 200
# fused-select and walk checks: sizes around one cluster's 8,192 threads
SELECT_SIZES = (7, 1000, 8191, 8192, 8193, 73_496)
SELECT_STATES = 3                # random job tables per size
ARCHIVE_JOBS = 73_496            # SDSC-SP2 log's job count
ARCHIVE_RUN_JOBS = ARCHIVE_JOBS // 8   # phase 5's run, cut to fit later ones
ARCHIVE_NODES = 128
PROFILE_JOBS = 250
# batched queue_select: launch times at B members of the golden runs' size
BATCH_SIZES = (8, 16)
BATCH_J = 10_000
# sweep phase: Fig. 4(b)'s grid; the 256-node members are held to solo runs
# of these policies (all six; trim here if the run nears its time limit)
SWEEP_POLICIES = ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")
SWEEP_NODES = (128, 256)
SWEEP_SOLO_POLICIES = ("backfill",)   # cut to fit the alloc phases, the oracle
ENSEMBLE_B = 8                   # ensemble phase: das2 trace seeds 0-7
ENSEMBLE_JOBS = 2_500            # each seed's jobs (cut to fit the windows)
ALLOCS = ("simple", "contiguous", "spread", "topo")
CONTENTIONS = (None, (1, 5))     # fig_alloc's two contention settings
# phase 6d runs Fig. alloc's grid solo at this contention only; the runs
# with contention (1, 5) meet their digests as members of phase 6e's sweep
# (cut to fit the DAG phases)
ALLOC_SOLO_CONTENTION = None
ALLOC_DIGESTS = ("start", "finish", "alloc_first", "alloc_span", "alloc_sum")
# dag_sweep phase: fig_workflow_cluster.py's grid, then a seed axis of a
# random layered DAG of the Galactic Plane run's task count (galactic_like's
# edge count is fixed by tiles and width, so its seeds are not ragged)
DAG_POLICIES = ("fcfs", "sjf", "backfill", "bestfit")
DAG_ALLOCS = ("simple", "contiguous", "topo")
DAG_SEEDS = (0, 1)
DAG_SEED_PARAMS = (("n_tasks", 5_000), ("n_layers", 64), ("p_edge", 0.0002))
DAG_SEED_POLICIES = ("backfill",)
# workflow phase: Fig. 6's largest DAG, checked by invariants only
WORKFLOW_BIG = (256, "fcfs_fit")
# the batched generic queue_select entry: members and row lengths (Fig. 6's
# 165-task DAG, the workflow golden runs' padded 2,625), and the two shapes
# timed (workflow_batch's ragged batch, Fig. 6's widest row)
GENERIC_BATCH_SIZES = (8, 24, 32)
GENERIC_BATCH_T = (165, 2625)
GENERIC_BATCH_TIMED = ((24, 2625), (32, 165))
# workflow_batch phase: Fig. 6's ensemble rows (fig6_workflow_scaling.py)
FIG6_WIDTHS = (1, 8, 32)
FIG6_DAG = (4, 12, 9)            # galactic_like(tiles, width, seed)
FIG6_POOLS = (64, 1 << 20)
WORKFLOW_BATCH_PROFILE_EVENTS = 60    # the ragged batch's profiled prefix
# flash_attention grid: (B, Sq, Sk, H, KV, hd), the CPU sweep's shapes
# plus the models' head dims and the serve shape
FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64), (1, 128, 384, 8, 8, 128), (2, 200, 200, 4, 1, 64),
    (1, 1, 256, 8, 2, 64), (2, 64, 512, 4, 4, 32), (2, 160, 160, 8, 2, 80),
    (1, 300, 300, 24, 8, 128), (2, 96, 352, 32, 8, 80),
    (4, 2048, 2048, 24, 8, 128),
]
FLASH_MASKS = [(True, None), (True, 96), (False, None)]
# bf16 only, the sm90 kernel's tiling: hd 80 (stablelm-3b's 32 heads),
# h2o-danube-1.8b's 32 over 8 heads with its window of 4,096 cutting tiles,
# and Sk = 2,049 (one key past a tile), whole and after a cache
FLASH_BF16_CASES = [
    ((1, 2048, 2048, 32, 32, 80), FLASH_MASKS),
    ((1, 4608, 4608, 32, 8, 80), [(True, 4096)]),
    ((1, 2049, 2049, 24, 8, 128), FLASH_MASKS),
    ((2, 77, 2049, 24, 8, 128), FLASH_MASKS),
]
FLASH_HD80 = (1, 2048, 2048, 32, 32, 80)   # timed, causal
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # as tests/test_kernels.py
FLASH_TIMED = 50
SERVE = {"batch": 4, "prompt_len": 2048, "gen": 32}
CHECK_LEN = 512                  # phase 9a's prompt
LM_TOL = 5e-4                    # f32 logits, see tests/test_torch_lm.py
CHECK_TOL = 1e-4                 # phases 9a and 12a, f32, kernel vs plain path
# phase 12a in bf16, kernel path vs plain path, as shares of the plain
# path's largest logit and largest final state entry.  A bf16 model moves
# both by itself: the CUDA-core kernel (f32 math, y rounded once, so it
# differs from the plain path by summation order alone) reads 0.04775 and
# 0.01180 on this prompt, the sm90 kernel (bf16 operands in its products)
# 0.06320 and 0.01853; both readings are deterministic.  A wrong state
# carry, decay or bonus is off by O(1).  The limits sit between the sm90
# kernel's readings and those of lower-precision builds of it
# (scripts/linattn_split.py --control, on an H100): kw truncated to 3
# mantissa bits reads 0.160 and 0.0819 and fails both.  A 2^-9 fault (kw
# rounded to bf16 once: 0.0597, 0.0199; the carried state rounded to bf16:
# 0.0618, 0.0208) is within this check's noise; phase 10's per-call state
# limit and the card test that holds the kernel to ref.py's statement of
# it fail both.
BF16_LOGIT_TOL = 0.08
BF16_STATE_TOL = 0.035
# linattn grid: (B, H, S, K, logw), logw None for -exp(N(0, 0.5^2)) as in
# test_kernels.py::test_linattn_sweep, else a constant
LINATTN_CASES = [
    (2, 3, 64, 16, None), (1, 2, 128, 64, None), (2, 1, 100, 32, None),
    (1, 4, 256, 64, None), (1, 2, 77, 128, None), (2, 2, 33, 64, None),
    (1, 2, 256, 32, -6.0),                    # steep decay
    (2, 4, 2045, 64, -math.exp(-6.0)),        # slow decay, ragged length
    (4, 64, 2048, 64, None),                  # the serve shape
]
# bf16 only, the sm90 route: steep decays at both key dims, and "mixed":
# each channel its own decay, from -30 to -1e-6 a step
LINATTN_BF16_CASES = [
    (1, 2, 256, 64, -6.0), (1, 2, 200, 128, -30.0),
    (2, 4, 333, 64, "mixed"), (1, 3, 130, 128, "mixed"),
]
LINATTN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}   # as tests/test_kernels.py
LINATTN_TIMED, LINATTN_PLAIN_TIMED = 50, 3
RWKV_SERVE = {"batch": 4, "prompt_len": 2048, "gen": 32}
RWKV_LIVE_SEED = 7


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


def time_ms(fn, n: int = TIMED_LAUNCHES, warm: int = 10) -> float:
    """Median of ``n`` calls, each timed with a CUDA event pair."""
    import torch
    for _ in range(warm):
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
    """``(device events, wall microseconds)`` of one call of ``fn`` under
    the profiler.  The profiler keeps a device event only inside its
    capture window, whose ends are read on the host's clock, while device
    events carry the card's timestamps converted to that clock; work right
    at either end can fall outside and be lost (scripts/profiler_window.py
    measures it).  PROFILE_PAD_S of host-only time at each end, outside
    the timed span, keeps every device event of ``fn`` inside."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t) * 1e6
        time.sleep(PROFILE_PAD_S)
    return device_events(prof), wall_us


def device_ops_per_call(torch, fn, calls: int, what: str, expect: int = 1):
    """``(device events, operations a call, profiles taken)`` of ``calls``
    calls of ``fn`` under the profiler; each call must be ``expect`` device
    operations.  More operations than that fail at once.  Fewer is what a
    dropped profiler event looks like (49 for 50 calls in one run, 94 for
    100 twice in another, before ``profiled`` padded its window), so the
    calls are profiled again once (profiles taken: 2), and only a second
    short count fails, naming the count of each operation.  ``({}, None,
    1)`` when the profiler shows no device event."""
    want = expect * calls
    for attempt in (1, 2):
        dev, _ = profiled(torch, lambda: [fn() for _ in range(calls)])
        if not dev:
            return dev, None, attempt
        n_ops = sum(k for k, _ in dev.values())
        check(n_ops <= want, f"{what}: {n_ops} device operations for "
              f"{calls} calls, expected {want}")
        if n_ops == want:
            return dev, float(expect), attempt
    check(False, f"{what}: {n_ops} device operations for {calls} calls in "
          f"two profiles, expected {want}: "
          f"{ {k: n for k, (n, _) in dev.items()} }")


def wall_ms(fn, n: int = TIMED_LAUNCHES, warm: int = 10) -> float:
    """Median host-clock time of ``n`` calls of a function that returns
    only after the device has finished (it reads its answer on the host)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def random_table(torch, np, rng, n: int, running_share: float):
    """A random job table and mid-run state on the card: ties in submit
    and estimate, priorities on either side of BIG, reservations before and
    after the clock.  Returns (TableSelect, jstate, rsv_finish, clock)."""
    from repro_torch.kernels.queue_select.ops import COLUMNS, TableSelect
    cols = {"submit": np.sort(rng.integers(0, max(n // 3, 1), n)),
            "estimate": rng.choice([60, 600, 3600, 7200, 43_200], n),
            "nodes": rng.integers(1, 129, n),
            "priority": BIG + rng.integers(-3, 3, n)}
    wait_share = (1 - running_share) / 2
    jstate = rng.choice([0, 1, 2, 3], n, p=[(1 - running_share) / 4,
                                             wait_share, running_share,
                                             (1 - running_share) / 4])
    clock = 50_000
    rsv = np.where(jstate == 2, clock + rng.integers(-3000, 40_000, n), BIG)
    def dev(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to("cuda")
    table = TableSelect({c: dev(cols[c]) for c in COLUMNS})
    return table, dev(jstate), dev(rsv), clock


def select_params(ref, table, jstate, rsv, clock, free, need):
    """Every mode's scalars as the engine derives them, from the plain
    versions: the FCFS head excluded, its shadow, the least waiting
    priority as the tier."""
    head, _ = ref.fused_select_reference(ref.HEAD_SUBMIT, table.cols, jstate)
    shadow, extra, _ = ref.shadow_walk_reference(
        table.cols["nodes"], jstate, rsv, clock, free, need)
    _, tier = ref.fused_select_reference(ref.PREEMPT_TIER, table.cols, jstate)
    return {"clock": clock, "free": free, "cap": free, "shadow": shadow,
            "extra": extra, "exclude": head, "tier": tier}


# columns each fused mode reads, jstate included (bytes a row)
MODE_BYTES = {"head_submit": 8, "head_estimate": 8, "head_neg_estimate": 8,
              "bestfit": 8, "any_fit": 8, "backfill_cand": 16,
              "preempt_tier": 8, "preempt_head": 12}
WALK_BYTES = 12
WALK_STEPS = 4                   # the timed walk's releases
# the modes whose mask reads the node column, held over a width column too
WIDTH_MODES = ("bestfit", "any_fit", "backfill_cand")


def phase_fused(torch, np, ops, ref):
    """Every fused mode and the walk against their plain versions, bit
    for bit; then their times and device operations per call."""
    t0 = time.time()
    rng = np.random.default_rng(1)
    n_checks, max_err, walk_err = 0, 0, 0
    width_checks = width_differs = 0

    def err(got, want) -> int:
        return max(abs(a - b) for a, b in zip(got, want))

    for n in SELECT_SIZES:
        for k in range(SELECT_STATES):
            # the engine's few running rows, then many (long walks)
            table, jstate, rsv, clock = random_table(
                torch, np, rng, n, (0.02, 0.1, 0.4)[k])
            run_nodes = int(torch.where(jstate == 2, table.cols["nodes"],
                                        0).sum())
            for free, need in ((0, 1), (37, 90), (5, run_nodes // 2),
                               (3, run_nodes + 4), (1, run_nodes + 9)):
                got = ops.shadow_walk(table, jstate, rsv, clock, free, need)
                want = ref.shadow_walk_reference(
                    table.cols["nodes"], jstate, rsv, clock, free, need)
                walk_err = max(walk_err, err(got, want))
                check(got == want, f"shadow walk N={n} free={free} "
                      f"need={need}: {got} != plain {want}")
                n_checks += 1
                p = select_params(ref, table, jstate, rsv, clock, free, need)
                for extra in (p["extra"], -1, 10**6):
                    for name, mode in ref.MODES.items():
                        q = dict(p, extra=extra)
                        got = table.select(mode, jstate, **q)
                        want = ref.fused_select_reference(
                            mode, table.cols, jstate, **q)
                        max_err = max(max_err, err(got, want))
                        check(got == want, f"fused {name} N={n} {q}: {got} "
                              f"!= plain {want}")
                        n_checks += 1
            # a malleable run's width column, passed with the call in place
            # of the bound node column (here narrower than it), once a table
            width = torch.from_numpy(rng.integers(1, 17, n).astype(
                np.int32)).to("cuda")
            p = select_params(ref, table, jstate, rsv, clock, 5,
                              run_nodes // 16 + 1)
            walk_w = (clock, 5, run_nodes // 16 + 1)
            got = ops.shadow_walk(table, jstate, rsv, *walk_w, nodes=width)
            want = ref.shadow_walk_reference(width, jstate, rsv, *walk_w)
            walk_err = max(walk_err, err(got, want))
            check(got == want, f"shadow walk over the width column N={n}: "
                  f"{got} != plain {want}")
            width_differs += got != ref.shadow_walk_reference(
                table.cols["nodes"], jstate, rsv, *walk_w)
            for name in WIDTH_MODES:
                mode = ref.MODES[name]
                got = table.select(mode, jstate, **p, nodes=width)
                want = ref.fused_select_reference(
                    mode, {**table.cols, "nodes": width}, jstate, **p)
                max_err = max(max_err, err(got, want))
                check(got == want, f"fused {name} over the width column "
                      f"N={n} {p}: {got} != plain {want}")
                width_differs += got != ref.fused_select_reference(
                    mode, table.cols, jstate, **p)
            width_checks += 1 + len(WIDTH_MODES)
    # the per-call column was read: over it some answers differ from the
    # bound column's, and every one equals the plain version over it
    check(width_differs > 0, "no answer over the width column differs from "
          "the bound column's: the kernel may not read the per-call column")

    # times at the archive run's shape with the engine's running share
    n = ARCHIVE_JOBS
    table, jstate, rsv, clock = random_table(torch, np, rng, n, 0.01)
    nodes = table.cols["nodes"]
    run_nodes = int(torch.where(jstate == 2, nodes, 0).sum())
    order = torch.sort(torch.where(jstate == 2,
                                   torch.clamp(rsv, min=clock + 1), BIG),
                       stable=True)[1]
    free = 3
    cum = free + torch.cumsum(nodes[order], 0)
    check(int((jstate == 2).sum()) >= 65, "too few running rows for a "
          "65-step walk")
    need = int(cum[WALK_STEPS - 1])      # a walk of WALK_STEPS releases
    p = select_params(ref, table, jstate, rsv, clock, free, need)
    ops.reset_launches()
    modes = {}
    for name, mode in ref.MODES.items():
        nbytes = MODE_BYTES[name] * n
        modes[name] = {
            "ms": wall_ms(lambda: table.select(mode, jstate, **p)),
            "plain_ms": wall_ms(lambda: ref.fused_select_reference(
                mode, table.cols, jstate, **p), 50),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    walk_args = (table, jstate, rsv, clock, free, need)
    # a walk's cost a step: device time of walks of 1 and 65 steps
    step_us = []
    for k in (1, 65):
        args = (table, jstate, rsv, clock, free, int(cum[k - 1]))
        dev, _ = profiled(torch, lambda: [ops.shadow_walk(*args)
                                          for _ in range(20)])
        step_us.append(sum(us for _, us in dev.values()) / 20 if dev
                       else None)
    walk = {"ms": wall_ms(lambda: ops.shadow_walk(*walk_args)),
            "plain_ms": wall_ms(lambda: ref.shadow_walk_reference(
                nodes, jstate, rsv, clock, free, need), 50),
            "bytes": WALK_BYTES * n,
            "bound_ms": WALK_BYTES * n / HBM_BYTES_PER_S * 1e3,
            "steps": WALK_STEPS, "running_rows": int((jstate == 2).sum()),
            "device_us_1_step": step_us[0] or "not measured",
            "device_us_per_step": (step_us[1] - step_us[0]) / 64
            if step_us[0] else "not measured",
            "max_abs_err": walk_err}

    # device operations and device time per call, every mode and the walk
    calls = 50
    calls_of = {name: (lambda mode=mode: table.select(mode, jstate, **p))
                for name, mode in ref.MODES.items()}
    calls_of["walk"] = lambda: ops.shadow_walk(*walk_args)
    for what, fn in calls_of.items():
        dev, ops_per_call, profiles = device_ops_per_call(torch, fn, calls,
                                                          what)
        d = modes[what] if what in modes else walk
        d["device_ops_per_call"] = ops_per_call or "not measured"
        d["profiles"] = profiles
        d["device_us_per_call"] = (sum(us for _, us in dev.values()) / calls
                                   if dev else "not measured")
    ops.reset_launches()
    emit("fused", t0, checks=n_checks, sizes=list(SELECT_SIZES),
         width_column_checks=width_checks,
         width_column_answers_differing=width_differs,
         max_abs_err=max_err, n=n, modes=modes, walk=walk)
    return max_err, modes, walk


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
    dev, ops_per_call, profiles = device_ops_per_call(
        torch, lambda: ops.queue_select(s, m), calls, "generic queue_select")
    device_us = sum(us for _, us in dev.values()) / calls
    bytes_moved = n * (4 + 1) + 2 * 4     # scores + bool mask read, i32[2]
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops.reset_launches()
    timing = {"n": n, "mask": "bool", "kernel_ms": kernel_ms,
              "device_us_per_call": device_us if dev else "not measured",
              "device_ops_per_call": ops_per_call or "not measured",
              "profiles": profiles,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library_call": "torch.min(torch.where(feasible, packed_key, "
                              "INT64_MAX)): two calls, packed key built "
                              "outside the timing",
              "bytes": bytes_moved, "bound_ms": bound_ms,
              "bound_us": bound_ms * 1e3}
    emit("kernel", t0, checks=n_checks, max_abs_err=max_err, **timing)
    return max_err, timing


def rigid_backfill(scn) -> bool:
    """Whether a run is a rigid backfill run, which must launch the walk.
    Every waiting malleable job asks for the same ``min_width``: a head
    that does not fit leaves no other job that fits, so the pass ends at
    its ANY_FIT test and no malleable run walks (as in the reference)."""
    return scn.policy == "backfill" and scn.malleable is None


def one_walk(scn) -> bool:
    """Whether a backfill run takes the batched pass, one shadow walk an
    event besides its redos: in scalar mode and under the strategies
    whose cap is the free count (the engine's ``_COUNT_CAPPED``).  Under
    ``contiguous`` and ``topo``, and in every malleable run (the per-start
    loop), each blocked selection walks."""
    return rigid_backfill(scn) and (scn.topology is None or scn.alloc
                                    in (None, "simple", "spread"))


def run_counted(rt, ops, scn, selects: bool = True):
    """One engine run on cuda with the kernels' launch counts around it:
    ``(result, wall seconds, counts)``.  ``selects=False``: a run whose
    pass makes no selection (the prefix pass), which must launch none."""
    import torch
    from repro_torch.core import engine
    ops.reset_launches()
    engine.reset_counters()
    t = time.time()
    res = rt.run(scn, device="cuda")
    out = res.to_np()
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = {"launches": ops.queue_select.launches,
              "walk_launches": ops.shadow_walk.launches,
              "walk_steps": ops.shadow_walk.steps,
              "redo_walks": engine.counters["redo"],
              "max_walks_per_event": engine.counters["max_walks_per_event"],
              "cap_reads": engine.counters["cap_reads"]}
    if selects:
        check(counts["launches"] > 0,
              f"{scn.policy} run launched no queue_select kernel")
    else:
        check(counts["launches"] == 0, f"{scn.policy} prefix-pass run made "
              f"{counts['launches']} selections")
    if rigid_backfill(scn):
        check(counts["walk_launches"] > 0,
              "backfill run launched no shadow-walk kernel")
    if one_walk(scn):
        check(counts["max_walks_per_event"] <= 1,
              f"an event launched the walk {counts['max_walks_per_event']} "
              "times besides its redo walks")
    if counts["walk_launches"]:
        counts["steps_per_walk"] = (counts["walk_steps"]
                                    / counts["walk_launches"])
    counts["launches_per_event"] = ((counts["launches"]
                                     + counts["walk_launches"])
                                    / out["n_events"])
    counts["cap_reads_per_event"] = counts["cap_reads"] / out["n_events"]
    return out, wall, counts


def check_golden(out, e, what: str = "") -> None:
    """A run's n_events, makespan and start/finish digests against the JAX
    engine's (an entry of tests/data/torch_port_golden.json)."""
    v = out["valid"]
    got = {"n_events": out["n_events"], "makespan": out["makespan"],
           "start_sha256": digest(out["start"][v]),
           "finish_sha256": digest(out["finish"][v])}
    for k, want in got.items():
        check(want == e[k], f"{what}{e['kind']}/{e['policy']}: {k} {want} "
              f"!= golden {e[k]}")


def phase_golden(rt, ops):
    t0 = time.time()
    entries = json.loads(GOLDEN.read_text())["runs"]
    launches = walks = 0
    runs = {}
    for e in entries:
        scn = rt.Scenario(
            trace=rt.SyntheticTrace(n_jobs=e["n_jobs"], seed=e["seed"],
                                    kind=e["kind"]),
            total_nodes=e["total_nodes"], policy=e["policy"])
        out, wall, counts = run_counted(rt, ops, scn)
        launches += counts["launches"]
        walks += counts["walk_launches"]
        check_golden(out, e)
        runs[(e["kind"], e["policy"])] = (out["n_events"], wall, counts)
        emit("golden", t0, kind=e["kind"], policy=e["policy"],
             n_jobs=e["n_jobs"], total_nodes=e["total_nodes"],
             n_events=out["n_events"], run_seconds=wall,
             events_per_s=out["n_events"] / wall, **counts,
             matches_jax=True)
    return launches, walks, runs


def phase_archive(rt, ops, np):
    t0 = time.time()
    scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=ARCHIVE_RUN_JOBS, seed=1,
                                              kind="sdsc_sp2"),
                      total_nodes=ARCHIVE_NODES, policy="backfill")
    out, wall, counts = run_counted(rt, ops, scn)
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
         makespan=out["makespan"], peak_busy_nodes=peak, **counts)
    return counts["launches"], counts["walk_launches"]


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


def stacked_table(torch, np, rng, n: int, shares):
    """One random table a running share (``random_table``), stacked: the
    ``BatchedTableSelect``, jstate and rsv_finish ``[B, n]``, the clock."""
    from repro_torch.kernels.queue_select.ops import COLUMNS, BatchedTableSelect
    parts = [random_table(torch, np, rng, n, s) for s in shares]
    table = BatchedTableSelect({c: torch.stack([p[0].cols[c] for p in parts])
                                for c in COLUMNS})
    return (table, torch.stack([p[1] for p in parts]),
            torch.stack([p[2] for p in parts]), parts[0][3])


def member_table(ops, table, b):
    """The solo ``TableSelect`` over member ``b``'s row of a stack."""
    return ops.TableSelect({c: t[b] for c, t in table.cols.items()})


def phase_batched(torch, np, ops, ref):
    """The batched entries against their plain versions and the solo
    kernel, bit for bit: phase 3's random tables stacked six at a time,
    each launch with idle members and mixed modes.  Then the time of a
    launch at B = 8 and 16 members of BATCH_J rows, every member asking for
    backfill's candidate (the widest mode) or a walk of WALK_STEPS
    releases."""
    t0 = time.time()
    rng = np.random.default_rng(2)
    n_checks, max_err = 0, 0
    shares = (0.02, 0.1, 0.4, 0.02, 0.1, 0.4)
    for n in SELECT_SIZES:
        table, jstate, rsv, clock = stacked_table(torch, np, rng, n, shares)
        B = table.batch
        for _ in range(SELECT_STATES):
            members = [b for b in range(B) if rng.random() < 0.7] or [1]
            rng.shuffle(members)
            selects, walks = [], []
            for b in members:
                free = int(rng.integers(0, 40))
                need = int(rng.integers(1, 3000))
                p = select_params(ref, member_table(ops, table, b), jstate[b],
                                  rsv[b], clock, free, need)
                p["extra"] = (p["extra"], -1, 10**6)[int(rng.integers(0, 3))]
                mode = int(rng.integers(0, len(ref.MODES)))
                selects.append((b, mode, ref.params(**p)))
                walks.append((b, ref.params(clock=clock, free=free,
                                            head_need=need)))
            modes, params, active = [0] * B, [None] * B, [False] * B
            for b, mode, p in selects:
                modes[b], active[b] = mode, True
                params[b] = dict(zip(ref.PARAMS[:-1], p[:-1]))
            got = table.select_batch(selects, jstate)
            want = ref.fused_select_batched_reference(modes, table.cols,
                                                      jstate, params, active)
            for (b, mode, p), g in zip(selects, got):
                solo = member_table(ops, table, b).select(mode, jstate[b],
                                                          *p[:-1])
                max_err = max(max_err, *(abs(x - y) for x, y in
                                         zip(g, want[b])))
                check(g == want[b] == solo, f"batched select N={n} member "
                      f"{b} mode {mode} {p}: {g}, plain {want[b]}, solo "
                      f"kernel {solo}")
                n_checks += 1
            wparams = [None] * B
            for b, p in walks:
                wparams[b] = dict(zip(ref.PARAMS, p))
            got = table.walk_batch(walks, jstate, rsv)
            want = ref.shadow_walk_batched_reference(
                table.cols["nodes"], jstate, rsv, wparams, active)
            for (b, p), g in zip(walks, got):
                solo = ops.shadow_walk(member_table(ops, table, b), jstate[b],
                                       rsv[b], p[0], p[1], p[-1])
                max_err = max(max_err, *(abs(x - y) for x, y in
                                         zip(g, want[b])))
                check(g == want[b] == solo, f"batched walk N={n} member {b} "
                      f"{p}: {g}, plain {want[b]}, solo kernel {solo}")
                n_checks += 1

    # one launch's time at the golden runs' table size, B members
    timing = {}
    for B in BATCH_SIZES:
        table, jstate, rsv, clock = stacked_table(torch, np, rng, BATCH_J,
                                                  (0.01,) * B)
        nodes = table.cols["nodes"]
        selects, walks, plain_args = [], [], []
        for b in range(B):
            order = torch.sort(torch.where(
                jstate[b] == 2, torch.clamp(rsv[b], min=clock + 1), BIG),
                stable=True)[1]
            free = 3
            need = int((free + torch.cumsum(nodes[b][order], 0))[
                WALK_STEPS - 1])
            p = select_params(ref, member_table(ops, table, b), jstate[b],
                              rsv[b], clock, free, need)
            selects.append((b, ref.BACKFILL_CAND, ref.params(**p)))
            walks.append((b, ref.params(clock=clock, free=free,
                                        head_need=need)))
            plain_args.append(p)
        active = [True] * B
        plain_select = lambda: ref.fused_select_batched_reference(  # noqa: E731
            [ref.BACKFILL_CAND] * B, table.cols, jstate, plain_args, active)
        wparams = [dict(zip(ref.PARAMS, p)) for _, p in walks]
        plain_walk = lambda: ref.shadow_walk_batched_reference(  # noqa: E731
            nodes, jstate, rsv, wparams, active)
        entry = {}
        for what, fn, plain, nbytes in (
                ("select", lambda: table.select_batch(selects, jstate),
                 plain_select, MODE_BYTES["backfill_cand"]),
                ("walk", lambda: table.walk_batch(walks, jstate, rsv),
                 plain_walk, WALK_BYTES)):
            check(fn() == plain(), f"batched {what} B={B}: kernel != plain")
            # two operations a call: the requests' upload and the kernel
            dev, per_call, profiles = device_ops_per_call(
                torch, fn, 50, f"batched {what} B={B}", 2)
            total = B * BATCH_J * nbytes
            entry[what] = {
                "ms": wall_ms(fn), "plain_ms": wall_ms(plain, 20),
                "members_per_launch": B, "bytes": total,
                "bound_ms": total / HBM_BYTES_PER_S * 1e3,
                "device_ops_per_call": per_call or "not measured",
                "profiles": profiles,
                "device_us_per_call": (sum(us for _, us in dev.values()) / 50
                                       if dev else "not measured")}
        timing[B] = entry
    generic_checks, generic_err, generic = generic_batch_checks(
        torch, np, ops, ref, rng)
    n_checks += generic_checks
    max_err = max(max_err, generic_err)
    ops.reset_launches()
    emit("batched", t0, checks=n_checks, sizes=list(SELECT_SIZES),
         max_abs_err=max_err, n=BATCH_J, timing=timing,
         generic_batch=generic)
    return max_err, timing, generic


def generic_batch_checks(torch, np, ops, ref, rng):
    """The batched generic entry (queue_select_batch: one upload of the
    requested rows, one launch of one cluster a row) against its plain
    version and the solo generic op on each row, bit for bit, at B members
    of T entries (GENERIC_BATCH_SIZES x GENERIC_BATCH_T): random scores
    with ties, rows all infeasible and rows scoring BIG, bool and int32
    masks, every member or a shuffled part of them.  Then, at the
    GENERIC_BATCH_TIMED shapes with every member requested, a launch's time
    by the host clock (the call returns once the answers are in host
    memory) beside the plain version, the two-call PyTorch form over [B, T]
    and the bound (B x T x 5 B), and its device operations (two: the
    members' upload and the kernel).  Returns (checks, max error, timing
    by "BxT")."""
    n_checks, max_err = 0, 0
    for B in GENERIC_BATCH_SIZES:
        for T in GENERIC_BATCH_T:
            scores = rng.integers(-1000, 1001, (B, T)).astype(np.int32)
            feas = rng.random((B, T)) < rng.choice([0.0, 0.02, 0.5, 1.0],
                                                   (B, 1))
            scores[0] = BIG
            s = torch.from_numpy(scores).to("cuda")
            for mask in (torch.from_numpy(feas).to("cuda"),
                         torch.from_numpy(feas.astype(np.int32)).to("cuda")):
                for members in (list(range(B)),
                                [int(b) for b in rng.permutation(B)[:B // 3]]):
                    got = ops.queue_select_batch(s, mask, members)
                    want = ref.queue_select_batched_reference(s, mask,
                                                              members)
                    for b, g, w in zip(members, got, want):
                        solo = tuple(ops.queue_select(s[b], mask[b]).tolist())
                        max_err = max(max_err, *(abs(x - y) for x, y in
                                                 zip(g, w)))
                        check(g == w == solo, f"batched generic B={B} T={T} "
                              f"row {b}: {g}, plain {w}, solo kernel {solo}")
                        n_checks += 1
    timing = {}
    for B, T in GENERIC_BATCH_TIMED:
        s = torch.from_numpy(rng.integers(0, 10**6, (B, T)).astype(
            np.int32)).to("cuda")
        m = torch.from_numpy(rng.random((B, T)) < 0.5).to("cuda")
        members = list(range(B))
        fn = lambda: ops.queue_select_batch(s, m, members)  # noqa: E731
        plain = lambda: ref.queue_select_batched_reference(  # noqa: E731
            s, m, members)
        check(fn() == plain(), f"batched generic B={B} T={T}: kernel != "
              "plain")
        # (score, index) packed so that int64 order is lexicographic order
        key = (s.to(torch.int64) << 32) | torch.arange(T, device="cuda")
        sentinel = torch.iinfo(torch.int64).max
        library = lambda: torch.min(  # noqa: E731
            torch.where(m, key, sentinel), dim=1).values.tolist()
        dev, per_call, profiles = device_ops_per_call(
            torch, fn, 50, f"batched generic B={B} T={T}", 2)
        total = B * T * 5 + B * 2 * 4   # scores and mask read, answers out
        timing[f"{B}x{T}"] = {
            "ms": wall_ms(fn), "plain_ms": wall_ms(plain, 20),
            "library_ms": wall_ms(library),
            "library_call": "torch.min(torch.where(feasible, packed_key, "
                            "INT64_MAX), dim=1) and the read of the [B] "
                            "answers: two calls and a copy, packed key "
                            "built outside the timing",
            "members_per_launch": B, "bytes": total,
            "bound_ms": total / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "device_ops_per_call": per_call or "not measured",
            "profiles": profiles,
            "device_us_per_call": (sum(us for _, us in dev.values()) / 50
                                   if dev else "not measured")}
    return n_checks, max_err, timing


def batch_counts(ops, engine) -> dict:
    return {"launches": ops.queue_select.launches,
            "walk_launches": ops.shadow_walk.launches,
            "batch_launches": ops.queue_select.batch_launches,
            "batch_selections": ops.queue_select.batch_selections,
            "walk_batch_launches": ops.shadow_walk.batch_launches,
            "walk_batch_walks": ops.shadow_walk.batch_walks,
            "redo_walks": engine.counters["redo"],
            "max_walks_per_event": engine.counters["max_walks_per_event"],
            "cap_reads": engine.counters["cap_reads"]}


def run_sweep(torch, rt, ops, scn, axes, what: str):
    """One ``sweep`` on cuda with the kernels' counts set to 0 before and
    read after: ``(grid, result dicts, wall seconds, counts)``.  It must
    have launched the batched kernels (the walk's too, with a backfill
    member), no solo one, and, where every backfill member takes the
    batched pass, one walk a member an event besides the redos."""
    from repro_torch.core import engine
    ops.reset_launches()
    engine.reset_counters()
    t = time.time()
    grid = rt.sweep(scn, axes=axes)
    outs = [r.to_np() for r in grid.results]
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = batch_counts(ops, engine)
    check(counts["batch_launches"] > 0,
          f"{what}: the sweep launched no batched queue_select kernel")
    if any(rigid_backfill(r.scenario) for r in grid.results):
        check(counts["walk_batch_launches"] > 0,
              f"{what}: a backfill sweep launched no batched walk")
    if all(one_walk(r.scenario) for r in grid.results
           if r.scenario.policy == "backfill"):
        check(counts["max_walks_per_event"] <= 1,
              f"{what}: a member walked {counts['max_walks_per_event']} "
              "times in one event besides its redo walks")
    check(counts["launches"] == counts["walk_launches"] == 0,
          f"{what}: the sweep launched a solo kernel: {counts}")
    events = sum(o["n_events"] for o in outs)
    counts.update(
        events=events, events_per_s=events / wall,
        selections_per_batch_launch=(counts["batch_selections"]
                                     / counts["batch_launches"]),
        batch_launches_per_event_round=(
            (counts["batch_launches"] + counts["walk_batch_launches"])
            / max(o["n_events"] for o in outs)))
    return grid, outs, wall, counts


SAME = ("start", "finish", "n_events", "makespan", "done")


def check_same(out, solo, what: str) -> None:
    import numpy as np
    for k in SAME:
        check(np.array_equal(out[k], solo[k]), f"{what}: {k} differs from "
              "the solo run")


def phase_sweep(torch, rt, ops):
    """Fig. 4(b)'s shape at the golden runs' size: the six policies on 128
    and 256 SDSC-SP2 nodes, one bucket of 12 members; the 128-node members
    held to the JAX digests, the 256-node ones to solo runs on the card.
    Then das2 on 400 nodes over fcfs and backfill, held to its digests."""
    t0 = time.time()
    golden = {(e["kind"], e["policy"]): e
              for e in json.loads(GOLDEN.read_text())["runs"]}
    base = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=10_000, seed=1,
                                               kind="sdsc_sp2"),
                       total_nodes=128)
    grid, outs, wall, counts = run_sweep(
        torch, rt, ops, base, {"policy": SWEEP_POLICIES,
                               "total_nodes": SWEEP_NODES}, "sdsc_sp2 sweep")
    check(grid.n_compiles == 1, f"{grid.n_compiles} buckets, expected 1")
    solo_s = 0.0
    for point, out in zip(grid.points, outs):
        if point["total_nodes"] == 128:
            check_golden(out, golden[("sdsc_sp2", point["policy"])], "sweep ")
        elif point["policy"] in SWEEP_SOLO_POLICIES:
            t = time.time()
            solo = rt.run(base.with_(**point)).to_np()
            solo_s += time.time() - t
            check_same(out, solo, f"sweep {point}")
    das2 = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=10_000, seed=0,
                                               kind="das2"), total_nodes=400)
    grid2, outs2, wall2, counts2 = run_sweep(
        torch, rt, ops, das2, {"policy": ("fcfs", "backfill")}, "das2 sweep")
    for point, out in zip(grid2.points, outs2):
        check_golden(out, golden[("das2", point["policy"])], "sweep ")
    ops.reset_launches()
    emit("sweep", t0, grid="sdsc_sp2 seed 1, 10,000 jobs: policy x "
         f"total_nodes {list(SWEEP_NODES)}", n_compiles=grid.n_compiles,
         members=len(grid), run_seconds=wall, **counts,
         solo_checked=[p for p in SWEEP_SOLO_POLICIES],
         solo_seconds=solo_s, matches_jax=True,
         das2={"members": len(grid2), "run_seconds": wall2, **counts2})
    return counts, counts2


def phase_ensemble(torch, rt, ops):
    """Fig. 5(a)'s shape: das2 backfill on 400 nodes, ENSEMBLE_JOBS jobs,
    trace seeds 0-7 as one batch of 8 and as a serial loop of ``run``,
    member by member equal; B = 1 through ``sweep`` against the solo run;
    a profiled 250-job batch of 8 for the card's busy share."""
    t0 = time.time()
    base = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=ENSEMBLE_JOBS, seed=0,
                                               kind="das2"),
                       total_nodes=400, policy="backfill")
    seeds = list(range(ENSEMBLE_B))
    grid, outs, wall, counts = run_sweep(torch, rt, ops, base,
                                         {"trace.seed": seeds}, "ensemble")
    serial = []
    for s, out in zip(seeds, outs):
        t = time.time()
        solo = rt.run(base.with_(**{"trace.seed": s})).to_np()
        torch.cuda.synchronize()
        serial.append(time.time() - t)
        check_same(out, solo, f"ensemble seed {s}")
    serial_s, solo0_s = sum(serial), serial[0]
    # B = 1 through sweep: the lockstep driver's own cost
    _, outs1, wall1, _ = run_sweep(torch, rt, ops, base, {"trace.seed": [0]},
                                   "ensemble B=1")
    check_same(outs1[0], outs[0], "ensemble B=1")
    # the card's busy share of a short batch (phase profile's runs, 8 seeds)
    small = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=PROFILE_JOBS, seed=1,
                                                kind="sdsc_sp2"),
                        total_nodes=ARCHIVE_NODES, policy="backfill")
    dev, wall_us = profiled(torch, lambda: [r.to_np() for r in rt.sweep(
        small, axes={"trace.seed": list(range(1, ENSEMBLE_B + 1))}).results])
    busy_us = sum(us for _, us in dev.values())
    ops.reset_launches()
    events = counts["events"]
    emit("ensemble", t0, members=len(grid), run_seconds=wall, **counts,
         serial_seconds=serial_s, serial_events_per_s=events / serial_s,
         batch_over_serial=serial_s / wall, b1_seconds=wall1,
         b1_events_per_s=outs1[0]["n_events"] / wall1,
         solo_seed0_seconds=solo0_s,
         b1_over_solo=wall1 / solo0_s, matches_serial=True,
         n_jobs=ENSEMBLE_JOBS,
         profile={"n_jobs": PROFILE_JOBS, "members": ENSEMBLE_B,
                  "wall_s": wall_us / 1e6, "device_busy_s": busy_us / 1e6,
                  "device_busy_share": busy_us / wall_us if dev
                  else "not measured"})
    return counts


def alloc_scenario(rt, e):
    """The scenario of an entry of tests/data/torch_alloc_golden.json."""
    con = e["contention"]
    return rt.Scenario(
        trace=rt.SyntheticTrace(n_jobs=e["n_jobs"], seed=e["seed"],
                                kind=e["kind"]),
        topology=rt.Topology(e["topology"][0], tuple(e["topology"][1])),
        policy=e["policy"], alloc=e["alloc"],
        contention=None if con is None else tuple(con))


def alloc_key(scn) -> tuple:
    """(kind, policy, alloc, contention) of a machine-mode scenario."""
    return (scn.trace.kind, scn.policy, scn.alloc, scn.contention)


def alloc_golden():
    """The entries of tests/data/torch_alloc_golden.json by
    :func:`alloc_key`."""
    return {(e["kind"], e["policy"], e["alloc"],
             None if e["contention"] is None else tuple(e["contention"])): e
            for e in json.loads(ALLOC_GOLDEN.read_text())["runs"]}


def check_alloc_golden(out, e, what: str = "") -> None:
    """A machine-mode run's n_events, makespan and digests (start, finish,
    the allocation fingerprints, the ev_lfb log) against the JAX engine's
    (an entry of tests/data/torch_alloc_golden.json)."""
    v = out["valid"]
    got = {"n_events": out["n_events"], "makespan": out["makespan"],
           "ev_lfb_sha256": digest(out["ev_lfb"])}
    got.update({f"{k}_sha256": digest(out[k][v]) for k in ALLOC_DIGESTS})
    for k, want in got.items():
        check(want == e[k], f"{what}{e['kind']}/{e['policy']}/{e['alloc']}/"
              f"{e['contention']}: {k} {want} != golden {e[k]}")


def phase_alloc(torch, rt, ops, golden_runs=None):
    """Topology-aware allocation at full size, each run held to its JAX
    digests: Fig. alloc's grid (SDSC-SP2-like seed 1, 1,250 jobs, on
    dragonfly(16, 8), backfill x the four strategies at
    ``ALLOC_SOLO_CONTENTION``; the rest of the grid meets its digests in
    phase alloc_sweep); the per-start loop on DAS-2's 400 nodes as mesh2d(20, 20)
    (fcfs/topo, sjf/spread, bestfit/contiguous); preempt/contiguous on the
    SDSC-SP2 machine, which reaches contiguous's fallback.  First, the
    scalar-mode SDSC-SP2 backfill run of the same jobs, the paired
    reference for what machine mode costs: phase 4's run of this call
    (``golden_runs``) when the job counts agree, else run here (held to
    phase 4's digests only at its size)."""
    t0 = time.time()
    golden = {(e["kind"], e["policy"]): e
              for e in json.loads(GOLDEN.read_text())["runs"]}
    e = golden[("sdsc_sp2", "backfill")]
    n_jobs = json.loads(ALLOC_GOLDEN.read_text())["runs"][0]["n_jobs"]
    held = {"matches_jax": True} if n_jobs == e["n_jobs"] else {}
    if golden_runs is not None and held:
        n_events, wall, counts = golden_runs[("sdsc_sp2", "backfill")]
        source = "phase 4's run"
    else:
        scn = rt.Scenario(trace=rt.SyntheticTrace(
            n_jobs=n_jobs, seed=e["seed"], kind=e["kind"]),
            total_nodes=e["total_nodes"], policy="backfill")
        out, wall, counts = run_counted(rt, ops, scn)
        if held:
            check_golden(out, e, "alloc scalar reference ")
        n_events, source = out["n_events"], "run here"
    emit("alloc", t0, run="scalar reference", source=source,
         kind=e["kind"], policy="backfill", n_jobs=n_jobs,
         total_nodes=e["total_nodes"], n_events=n_events, run_seconds=wall,
         events_per_s=n_events / wall, **counts, **held)
    launches = walks = 0
    solo = {}
    for e in json.loads(ALLOC_GOLDEN.read_text())["runs"]:
        scn = alloc_scenario(rt, e)
        if (e["kind"], e["policy"]) == ("sdsc_sp2", "backfill") and (
                scn.contention != ALLOC_SOLO_CONTENTION):
            continue
        out, wall, counts = run_counted(rt, ops, scn)
        check_alloc_golden(out, e)
        launches += counts["launches"]
        walks += counts["walk_launches"]
        solo[alloc_key(scn)] = (out["n_events"], wall)
        emit("alloc", t0, kind=e["kind"], topology=e["topology"],
             policy=e["policy"], alloc=e["alloc"],
             contention=e["contention"], n_events=out["n_events"],
             makespan=out["makespan"], run_seconds=wall,
             events_per_s=out["n_events"] / wall,
             scheduling_pass=("batched" if one_walk(scn) else "per-start loop"),
             **counts, matches_jax=True)
    # the card's busy share and device operations an event of a short
    # machine-mode run (phase 6's solo run, on the SDSC-SP2 machine)
    small = rt.Scenario(
        trace=rt.SyntheticTrace(n_jobs=PROFILE_JOBS, seed=1, kind="sdsc_sp2"),
        topology=rt.Topology.dragonfly(16, 8), policy="backfill",
        alloc="simple")
    box = {}
    dev, wall_us = profiled(torch, lambda: box.update(
        out=rt.run(small, device="cuda").to_np()))
    busy_us = sum(us for _, us in dev.values())
    top = sorted(dev.items(), key=lambda kv: kv[1][1], reverse=True)[:6]
    emit("alloc", t0, run="profile", n_jobs=PROFILE_JOBS, policy="backfill",
         alloc="simple", n_events=box["out"]["n_events"],
         wall_s=wall_us / 1e6, device_busy_s=busy_us / 1e6,
         device_busy_share=busy_us / wall_us if dev else "not measured",
         device_events_per_event=(sum(k for k, _ in dev.values())
                                  / box["out"]["n_events"] if dev
                                  else "not measured"),
         top_device_us={name[:60]: us for name, (_, us) in top})
    return {"launches": launches, "walk_launches": walks, "solo": solo}


def phase_alloc_sweep(torch, rt, ops, solo):
    """Fig. alloc's grid through ``sweep``: the four strategies x the two
    contention settings as one bucket of 8 members in lockstep, each held
    to its solo run's JAX digests; events/s against those of the grid's
    solo runs in phase alloc (``solo``, when it ran in this call: the four
    at ``ALLOC_SOLO_CONTENTION``)."""
    t0 = time.time()
    golden = alloc_golden()
    e = golden[("sdsc_sp2", "backfill", "simple", None)]
    base = alloc_scenario(rt, e).with_(alloc=None)
    grid, outs, wall, counts = run_sweep(
        torch, rt, ops, base, {"alloc": ALLOCS, "contention": CONTENTIONS},
        "alloc sweep")
    check(grid.n_compiles == 1, f"{grid.n_compiles} buckets, expected 1")
    keys = [alloc_key(r.scenario) for r in grid.results]
    for k, out in zip(keys, outs):
        check_alloc_golden(out, golden[k], "alloc sweep ")
    timed = [k for k in keys if solo is not None and k in solo]
    solo_eps = (sum(solo[k][0] for k in timed) / sum(solo[k][1]
                                                     for k in timed)
                if timed else "not measured")
    ops.reset_launches()
    emit("alloc_sweep", t0, grid=f"sdsc_sp2 seed 1, {e['n_jobs']:,} jobs, "
         "dragonfly(16, 8), backfill: alloc x contention",
         n_compiles=grid.n_compiles, members=len(grid), run_seconds=wall,
         **counts, solo_runs=len(timed), solo_events_per_s=solo_eps,
         batch_over_solo_rate=(counts["events_per_s"] / solo_eps if timed
                               else "not measured"),
         matches_jax=True)
    return counts


def dag_scenario(rt, e):
    """The scenario of an entry of tests/data/torch_dag_golden.json."""
    dag = e["dag"]
    trace = rt.WorkflowTrace(
        kind=dag["kind"], seed=dag["seed"], priority=e["priority"],
        params=(("tiles", dag["tiles"]), ("width", dag["width"])))
    if e["topology"] is None:
        return rt.Scenario(trace=trace, total_nodes=e["total_nodes"],
                           policy=e["policy"])
    return rt.Scenario(trace=trace, policy=e["policy"], alloc=e["alloc"],
                       topology=rt.Topology(e["topology"][0],
                                            tuple(e["topology"][1])),
                       contention=tuple(e["contention"]))


def dag_key(scn) -> tuple:
    """(policy, topology kind, alloc, contention) of a DAG scenario."""
    return (scn.policy, None if scn.topology is None else scn.topology.kind,
            scn.alloc, None if scn.contention is None
            else tuple(scn.contention))


def prefix_pass(scn) -> bool:
    """Whether a run on a table with edges takes the blocking prefix pass,
    which makes no selection: FCFS, SJF and LJF in scalar mode and under
    the count-capped strategies."""
    return scn.policy in ("fcfs", "sjf", "ljf") and (
        scn.topology is None or scn.alloc in (None, "simple", "spread"))


def check_dag_golden(out, e, what: str = "") -> None:
    """A DAG run's n_events, makespan and digests (start, finish, ready;
    on a machine the allocation fingerprints and the ev_lfb log) against
    the JAX engine's."""
    v = out["valid"]
    got = {"n_events": out["n_events"], "makespan": out["makespan"]}
    got.update({k: digest(out[k[:-len("_sha256")]][v]) for k in e
                if k.endswith("_sha256") and k != "ev_lfb_sha256"})
    if "ev_lfb_sha256" in e:
        got["ev_lfb_sha256"] = digest(out["ev_lfb"])
    check(int(v.sum()) == e["n_jobs"], f"{what}{e['n_jobs']} jobs expected")
    for k, want in got.items():
        check(want == e[k], f"{what}{e['policy']}/{e['alloc']}/"
              f"{e['contention']}: {k} {want} != golden {e[k]}")


def dag_run(rt, ops, e, what: str = ""):
    """One DAG run on cuda held to its golden entry ``e``: ``(result, wall
    seconds, counts)`` with the per-run rates."""
    scn = dag_scenario(rt, e)
    out, wall, counts = run_counted(rt, ops, scn,
                                    selects=not prefix_pass(scn))
    check_dag_golden(out, e, what)
    check(bool(out["done"][out["valid"]].all()), f"{what}unfinished jobs")
    n_jobs = int(out["valid"].sum())
    counts.update(events_per_s=out["n_events"] / wall,
                  jobs_per_s=n_jobs / wall,
                  jobs_per_event=n_jobs / out["n_events"])
    return scn, out, wall, counts


def phase_dag(rt, ops, golden_runs=None):
    """Galactic Plane (10,497 tasks, 18,944 edges) on the cluster, solo:
    the six policies in scalar mode on 128 nodes (preempt over
    critical-path priorities), then backfill/topo, fcfs/contiguous and
    sjf/simple on dragonfly(16, 8) with contention (1, 5); each held to its
    JAX digests.  Scalar FCFS, SJF and LJF take the prefix pass and make no
    selection; the others must launch queue_select.  Beside them, phase
    4's scalar SDSC-SP2 fcfs run of this call (``golden_runs``), when it
    ran."""
    t0 = time.time()
    launches = walks = 0
    solo = {}
    for e in json.loads(DAG_GOLDEN.read_text())["runs"]:
        scn, out, wall, counts = dag_run(rt, ops, e)
        launches += counts["launches"]
        walks += counts["walk_launches"]
        solo[dag_key(scn)] = (out["n_events"], wall)
        emit("dag", t0, dag="galactic_like(256, 12, seed=0)",
             policy=e["policy"], priority=e["priority"],
             topology=e["topology"], alloc=e["alloc"],
             contention=e["contention"], n_jobs=e["n_jobs"],
             n_edges=e["n_edges"], n_events=out["n_events"],
             makespan=out["makespan"], run_seconds=wall,
             scheduling_pass=("prefix" if prefix_pass(scn) else
                              "batched" if one_walk(scn) else
                              "per-start loop"),
             **counts, matches_jax=True)
    if golden_runs is not None:
        n_events, wall, _ = golden_runs[("sdsc_sp2", "fcfs")]
        emit("dag", t0, run="phase 4's scalar sdsc_sp2 fcfs of this call",
             n_jobs=10_000, n_events=n_events, run_seconds=wall,
             events_per_s=n_events / wall, jobs_per_s=10_000 / wall,
             jobs_per_event=10_000 / n_events)
    return {"launches": launches, "walk_launches": walks, "solo": solo}


def phase_dag_sweep(torch, rt, ops, solo=None):
    """fig_workflow_cluster.py's grid at full scale through ``sweep``: the
    Galactic Plane DAG on dragonfly(16, 8) with contention (1, 5), fcfs,
    sjf, backfill, bestfit x simple, contiguous, topo, one bucket of 12
    members, each held to its solo run's JAX digests; its events/s beside
    the solo events/s of the three grid members phase dag ran (``solo``,
    when it ran in this call).  Then a seed axis over a random layered DAG
    of the same task count (ragged edge lists), backfill in scalar mode,
    one bucket of 2 members, each equal to its solo run."""
    import numpy as np
    t0 = time.time()
    golden = json.loads(DAG_SWEEP_GOLDEN.read_text())["runs"]
    base = dag_scenario(rt, golden[0]).with_(alloc=None)
    grid, outs, wall, counts = run_sweep(
        torch, rt, ops, base, {"policy": DAG_POLICIES, "alloc": DAG_ALLOCS},
        "dag sweep")
    check(grid.n_compiles == 1, f"{grid.n_compiles} buckets, expected 1")
    for r, out, e in zip(grid.results, outs, golden):
        check(dag_key(r.scenario) == dag_key(dag_scenario(rt, e)),
              "dag sweep: grid order differs from the golden file")
        check_dag_golden(out, e, "dag sweep ")
    keys = [dag_key(r.scenario) for r in grid.results]
    timed = [k for k in keys if solo is not None and k in solo]
    solo_eps = (sum(solo[k][0] for k in timed) / sum(solo[k][1]
                                                     for k in timed)
                if timed else "not measured")
    ops.reset_launches()
    emit("dag_sweep", t0, grid="galactic_like(256, 12), dragonfly(16, 8), "
         "contention (1, 5): policy x alloc", n_compiles=grid.n_compiles,
         members=len(grid), run_seconds=wall, **counts,
         solo_runs=[list(map(str, k)) for k in timed],
         solo_events_per_s=solo_eps,
         batch_over_solo_rate=(counts["events_per_s"] / solo_eps if timed
                               else "not measured"), matches_jax=True)

    # the seed axis: ragged edge lists in one bucket
    t1 = time.time()
    seed_base = rt.Scenario(trace=rt.WorkflowTrace(
        kind="random", params=DAG_SEED_PARAMS), total_nodes=128)
    grid2, outs2, wall2, counts2 = run_sweep(
        torch, rt, ops, seed_base, {"trace.seed": DAG_SEEDS,
                                    "policy": DAG_SEED_POLICIES},
        "dag seed sweep")
    check(grid2.n_compiles == 1, f"{grid2.n_compiles} buckets, expected 1")
    edges = [len(r.scenario.trace.materialize()["deps"])
             for r in grid2.results]
    check(len(set(edges)) > 1, f"seed axis edge counts {edges} not ragged")
    serial_s = 0.0
    for r, out in zip(grid2.results, outs2):
        t = time.time()
        one = rt.run(r.scenario).to_np()
        torch.cuda.synchronize()
        serial_s += time.time() - t
        check_same(out, one, f"dag seed sweep {r.scenario.policy}")
        check(bool(np.array_equal(out["ready"], one["ready"])),
              "dag seed sweep: ready differs from the solo run")
    ops.reset_launches()
    emit("dag_sweep", t1, grid="random_layered(5,000 tasks, 64 layers, "
         "p_edge 2e-4), 128 nodes: trace.seed x policy",
         n_edges=edges, edge_capacity=sorted({-(-n // 64) * 64
                                              for n in edges}),
         n_compiles=grid2.n_compiles, members=len(grid2),
         run_seconds=wall2, **counts2, serial_seconds=serial_s,
         serial_events_per_s=counts2["events"] / serial_s,
         batch_over_serial=serial_s / wall2, matches_solo=True)
    return counts, counts2


def workflow_invariants(np, wf, out, pools) -> int:
    """Every task done, no start before a dependency's finish, no resource
    over its pool at any instant (releases before starts at one time);
    returns the number of events checked."""
    v = out["valid"]
    check(bool(out["done"][v].all()), "workflow: a task is not done")
    t, d = (np.asarray(a) for a in zip(*wf["dep_pairs"]))
    check(bool((out["start"][t] >= out["finish"][d]).all()),
          "workflow: a task started before a dependency finished")
    st = out["start"][v].astype(np.int64)
    fin = out["finish"][v].astype(np.int64)
    res = np.asarray(wf["resources"], dtype=np.int64)
    times = np.concatenate([fin, st])
    delta = np.concatenate([-res, res])
    order = np.lexsort((np.concatenate([np.zeros_like(fin),
                                        np.ones_like(st)]), times))
    used = np.cumsum(delta[order], axis=0)
    check(bool((used <= np.asarray(pools)).all()),
          f"workflow: a pool was exceeded: {used.max(axis=0)}")
    return len(np.unique(times))


def phase_workflow(torch, np, rt, ops):
    """The standalone pool engine: Figs. 6 and 7's 24 runs (galactic_like
    tiles 2-64 on [64, 1 << 20], sipht_like widths 10-60 on [8, 8192],
    fcfs, fcfs_fit and cpath), each held to the JAX pool engine's digests,
    then galactic_like(256, 12, seed=256) under fcfs_fit, checked by
    invariants.  Every run must launch queue_select.  Returns the launches
    and the 24 runs' summed wall seconds."""
    from repro_torch.traces import workflows as W
    t0 = time.time()
    launches = 0

    def one(wf, pools, policy):
        prio = (rt.critical_path_length(wf["exec_time"], wf["dep_pairs"])
                if policy == "cpath" else None)
        ts = rt.make_taskset(wf["exec_time"], wf["resources"],
                             wf["dep_pairs"], priority=prio, device="cuda")
        ops.reset_launches()
        t = time.time()
        out = rt.workflow_result_np(ts, rt.simulate_workflow(
            ts, np.asarray(pools), rt.WF_POLICY_IDS[policy]))
        torch.cuda.synchronize()
        wall = time.time() - t
        n = ops.queue_select.launches
        check(n > 0, f"workflow {policy}: no queue_select launch")
        return out, wall, n

    golden_wall = 0.0
    for e in json.loads(WORKFLOW_GOLDEN.read_text())["runs"]:
        wf = workflow_golden_dag(W, e)
        out, wall, n = one(wf, e["pools"], e["policy"])
        golden_wall += wall
        launches += n
        v = out["valid"]
        got = {"n_events": out["n_events"], "makespan": out["makespan"],
               "done": bool(out["done"][v].all())}
        got.update({f"{k}_sha256": digest(out[k][v])
                    for k in ("start", "finish", "ready")})
        for k, want in got.items():
            check(want == e[k], f"workflow {e['kind']}/{e['size']}/"
                  f"{e['policy']}: {k} {want} != golden {e[k]}")
        emit("workflow", t0, kind=e["kind"], size=e["size"],
             pools=e["pools"], policy=e["policy"], n_tasks=e["n_tasks"],
             n_events=out["n_events"], makespan=out["makespan"],
             run_seconds=wall, tasks_per_s=e["n_tasks"] / wall,
             launches=n, launches_per_task=n / e["n_tasks"],
             matches_jax=True)
    tiles, policy = WORKFLOW_BIG
    wf = W.galactic_like(tiles, 12, seed=tiles)
    pools = [64, 1 << 20]
    out, wall, n = one(wf, pools, policy)
    launches += n
    checked = workflow_invariants(np, wf, out, pools)
    n_tasks = int(out["valid"].sum())
    emit("workflow", t0, kind="galactic", size=tiles, pools=pools,
         policy=policy, n_tasks=n_tasks, n_edges=len(wf["dep_pairs"]),
         n_events=out["n_events"], makespan=out["makespan"],
         run_seconds=wall, tasks_per_s=n_tasks / wall, launches=n,
         launches_per_task=n / n_tasks, instants_checked=checked,
         invariants_hold=True)
    return launches, golden_wall


def workflow_golden_dag(W, e):
    """The DAG of an entry of tests/data/torch_workflow_golden.json
    (``W``: the port's workflow generators)."""
    if e["kind"] == "galactic":
        return W.galactic_like(e["size"], 12, seed=e["size"])
    return W.sipht_like(e["size"], seed=e["size"])


def workflow_taskset(rt, wf, policy):
    prio = (rt.critical_path_length(wf["exec_time"], wf["dep_pairs"])
            if policy == "cpath" else None)
    return rt.make_taskset(wf["exec_time"], wf["resources"], wf["dep_pairs"],
                           priority=prio, device="cuda")


def run_workflow_batch(torch, rt, ops, stack, pools, policies, what: str):
    """One batched pool-engine run on cuda with the batched generic entry's
    counts set to 0 before and read after: ``(state, wall seconds,
    counts)``.  It must launch the batched entry, and no solo selection."""
    ops.reset_launches()
    t = time.time()
    state = rt.simulate_workflow_ensemble(stack, pools, policies,
                                          device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = {"batch_launches": ops.queue_select_batch.launches,
              "batch_selections": ops.queue_select_batch.selections,
              "solo_launches": ops.queue_select.launches}
    check(counts["batch_launches"] > 0,
          f"{what}: no queue_select_batch launch")
    check(counts["solo_launches"] == 0,
          f"{what}: {counts['solo_launches']} solo selections")
    counts["selections_per_launch"] = (counts["batch_selections"]
                                       / counts["batch_launches"])
    return state, wall, counts


def phase_workflow_batch(torch, np, rt, ops, solo=None):
    """The batched pool engine (simulate_workflow_ensemble), members in
    lockstep, one batched generic queue_select launch a selection
    sub-round.  (a) Figs. 6 and 7's 24 runs of phase workflow as one
    ragged batch (padded to the largest DAG's 2,625 tasks, each member on
    its own pools and policy), every member held to its JAX digests;
    tasks/s beside the 24 solo runs of phase workflow (``solo``, their
    summed wall seconds, when it ran in this call), and the card's busy
    share of the batch's first WORKFLOW_BATCH_PROFILE_EVENTS events.  (b)
    Fig. 6's ensemble rows: W = 1, 8 and 32 copies of galactic_like(4, 12,
    seed=9) under fcfs_fit on [64, 1 << 20], tasks/s beside a serial loop
    of W solo runs in this process; every member equal to the solo card
    run and to the host oracle (refsim.simulate_workflow_reference), and
    the busy share of the W = 32 batch."""
    from repro_torch.refsim import simulate_workflow_reference
    from repro_torch.traces import workflows as W
    t0 = time.time()
    runs = json.loads(WORKFLOW_GOLDEN.read_text())["runs"]
    dags = [workflow_golden_dag(W, e) for e in runs]
    stack = rt.stack_tasksets([workflow_taskset(rt, wf, e["policy"])
                               for wf, e in zip(dags, runs)])
    pools = np.array([e["pools"] for e in runs])
    policies = [e["policy"] for e in runs]
    state, wall, counts = run_workflow_batch(torch, rt, ops, stack, pools,
                                             policies, "workflow_batch (a)")
    launches, selections = counts["batch_launches"], counts["batch_selections"]
    for b, e in enumerate(runs):
        out = rt.workflow_result_np(stack.member(b), state.member(b))
        v = out["valid"]
        got = {"n_events": out["n_events"], "makespan": out["makespan"],
               "done": bool(out["done"][v].all())}
        got.update({f"{k}_sha256": digest(out[k][v])
                    for k in ("start", "finish", "ready")})
        for k, want in got.items():
            check(want == e[k], f"workflow_batch member {b} {e['kind']}/"
                  f"{e['size']}/{e['policy']}: {k} {want} != golden {e[k]}")
    n_tasks = sum(e["n_tasks"] for e in runs)
    dev, wall_us = profiled(torch, lambda: rt.simulate_workflow_ensemble(
        stack, pools, policies, max_events=WORKFLOW_BATCH_PROFILE_EVENTS,
        device="cuda"))
    busy = sum(us for _, us in dev.values()) / wall_us if dev else \
        "not measured"
    emit("workflow_batch", t0, run="figs 6-7 golden runs as one batch",
         members=stack.batch, capacity=stack.capacity, n_tasks=n_tasks,
         max_member_events=max(state.n_events), run_seconds=wall,
         tasks_per_s=n_tasks / wall, **counts,
         solo_seconds=solo if solo is not None else "not run",
         batch_over_solo=solo / wall if solo is not None else "not run",
         busy_share_of_prefix=busy,
         profiled_events=WORKFLOW_BATCH_PROFILE_EVENTS, matches_jax=True)

    tiles, width, seed = FIG6_DAG
    wf = W.galactic_like(tiles, width, seed=seed)
    n = len(wf["exec_time"])
    oracle = simulate_workflow_reference(
        wf["exec_time"], wf["resources"], wf["dep_pairs"],
        np.asarray(FIG6_POOLS), "fcfs_fit")
    # the serial loop: solo card runs, each held to the oracle
    ts = workflow_taskset(rt, wf, "fcfs_fit")
    serial, solo_out = [], None
    for _ in range(max(FIG6_WIDTHS)):
        t = time.time()
        one = rt.workflow_result_np(ts, rt.simulate_workflow(
            ts, np.asarray(FIG6_POOLS), "fcfs_fit", device="cuda"))
        torch.cuda.synchronize()
        serial.append(time.time() - t)
        solo_out = one if solo_out is None else solo_out
        for k in ("start", "finish"):
            check(np.array_equal(one[k][:n], oracle[k]),
                  f"fig6 solo run: {k} differs from the host oracle")
    rows = {}
    for width in FIG6_WIDTHS:
        stack = rt.stack_tasksets([ts] * width)
        pools = np.broadcast_to(np.asarray(FIG6_POOLS), (width, 2))
        state, wall, counts = run_workflow_batch(
            torch, rt, ops, stack, pools, "fcfs_fit", f"fig6 W={width}")
        launches += counts["batch_launches"]
        selections += counts["batch_selections"]
        for b in range(width):
            out = rt.workflow_result_np(stack.member(b), state.member(b))
            for k, want in solo_out.items():
                check(np.array_equal(out[k], want), f"fig6 W={width} member "
                      f"{b}: {k} differs from the solo card run")
            for k in ("start", "finish"):
                check(np.array_equal(out[k][:n], oracle[k]), f"fig6 "
                      f"W={width} member {b}: {k} differs from the oracle")
        loop = sum(serial[:width])
        rows[width] = {"run_seconds": wall, "tasks_per_s": n * width / wall,
                       "serial_seconds": loop,
                       "serial_tasks_per_s": n * width / loop,
                       "batch_over_serial": loop / wall, **counts}
        if width == max(FIG6_WIDTHS):
            dev, wall_us = profiled(
                torch, lambda: rt.simulate_workflow_ensemble(
                    stack, pools, "fcfs_fit", device="cuda"))
            rows[width]["busy_share"] = (
                sum(us for _, us in dev.values()) / wall_us if dev
                else "not measured")
    emit("workflow_batch", t0, run="fig6 ensemble rows", dag=list(FIG6_DAG),
         n_tasks=n, n_edges=len(wf["dep_pairs"]), pools=list(FIG6_POOLS),
         policy="fcfs_fit", widths=rows, matches_solo=True,
         matches_oracle=True)
    return {"launches": launches, "selections": selections}


def oracle_scenarios(rt) -> dict:
    """About twelve runs of about 2,000 jobs, one or more from each family
    the port runs, with seeds that appear in no golden file."""
    def sdsc(seed):
        return rt.SyntheticTrace(n_jobs=2000, seed=seed, kind="sdsc_sp2",
                                 congest=4)
    runs = {f"sdsc_{p}": rt.Scenario(trace=sdsc(101), total_nodes=128,
                                     policy=p)
            for p in ("fcfs", "sjf", "ljf", "bestfit", "backfill", "preempt")}
    runs["das2_mesh2d_spread"] = rt.Scenario(
        trace=rt.SyntheticTrace(n_jobs=2000, seed=102, kind="das2"),
        topology=rt.Topology.mesh2d(20, 20), alloc="spread",
        contention=(1, 5), policy="backfill")
    galactic = rt.WorkflowTrace(kind="galactic", seed=103,
                                params=(("tiles", 48), ("width", 12)))
    runs["galactic_backfill"] = rt.Scenario(trace=galactic, total_nodes=128,
                                            policy="backfill")
    runs["galactic_fcfs"] = rt.Scenario(trace=galactic, total_nodes=128,
                                        policy="fcfs")
    runs["requeue"] = rt.Scenario(
        trace=sdsc(104), total_nodes=128, policy="backfill",
        failures=rt.FailureModel(mtbf=50e3, seed=104, mean_repair=600,
                                 horizon=2**19, max_failures=2048,
                                 checkpoint_interval=3600))
    runs["serving_autoscaler"] = rt.Scenario(trace=rt.ServiceTrace(
        horizon=2**16, rate=0.03, seed=105, max_jobs=4096,
        classes=(rt.ServiceClass("interactive", nodes=1, mean_runtime=30,
                                 slo_wait=60),
                 rt.ServiceClass("batch", nodes=8, mean_runtime=600,
                                 dist="exponential", slo_wait=1800,
                                 weight=0.3)),
        autoscale=rt.AutoscalePolicy(up_threshold=48, down_threshold=8,
                                     min_nodes=16, max_nodes=64, step=8,
                                     interval=256, max_ticks=256)),
        total_nodes=64, policy="fcfs")
    runs["moldable"] = rt.Scenario(
        trace=sdsc(106), total_nodes=128, policy="backfill",
        malleable=rt.MalleableModel(curve="amdahl", param=0.1, min_width=1,
                                    max_width=16, mode="moldable"))
    return runs


# the oracle's columns that are not per-job, or not the engine's
ORACLE_SKIP = ("valid", "ev_time", "ev_free", "ev_lfb", "kill_log")


def phase_oracle(rt, ops, np):
    """Card runs of rt.run held to the host oracle rt.run_ref, key by key,
    on scenarios without a digest (oracle_scenarios): every per-job column
    the oracle returns (over its rows), n_events and makespan; the
    oracle's host seconds beside each card run's."""
    t0 = time.time()
    launches = walks = 0
    for name, scn in oracle_scenarios(rt).items():
        edges = scn.trace.static_key()[0] == "workflow"
        out, wall, counts = run_counted(
            rt, ops, scn, selects=not (edges and prefix_pass(scn)))
        launches += counts["launches"]
        walks += counts["walk_launches"]
        t = time.time()
        ref = rt.run_ref(scn).to_np()
        ref_s = time.time() - t
        bad = []
        for k, want in ref.items():
            if k in ORACLE_SKIP:
                continue
            got, want = np.asarray(out[k]), np.asarray(want)
            if got.ndim == 1 and got.shape != want.shape:
                got = got[:len(want)]
            if got.shape != want.shape or not np.array_equal(got, want):
                bad.append(k)
        check(not bad, f"oracle {name}: the card run differs from run_ref "
              f"on {bad}")
        emit("oracle", t0, run=name, policy=scn.policy,
             n_jobs=len(ref["start"]), n_events=out["n_events"],
             makespan=out["makespan"], card_seconds=wall,
             oracle_host_seconds=ref_s, keys_compared=len(ref) - sum(
                 k in ref for k in ORACLE_SKIP),
             kills=len(ref.get("kill_log", ())), **counts,
             matches_run_ref=True)
    return {"launches": launches, "walk_launches": walks}


# ---------------------------------------------------------------------------
# node failures and online serving (the stream event sources)
# ---------------------------------------------------------------------------

STREAM_KEYS = ("failures", "repairs", "ticks", "requeues", "aborts",
               "stream_reads")


def build_spec(rt, spec):
    """A golden entry's nested spec (dicts with a ``type``, lists for
    tuples) made with the port's classes."""
    if isinstance(spec, dict) and "type" in spec:
        return getattr(rt, spec["type"])(**{
            k: build_spec(rt, v) for k, v in spec.items()
            if k != "type" and v is not None})
    if isinstance(spec, list):
        return tuple(build_spec(rt, v) for v in spec)
    return spec


def stream_scenario(rt, e):
    """The scenario of an entry of the rel or serving golden file, every
    stream checked untruncated and of the entry's size."""
    scn = build_spec(rt, e["scenario"])
    if e["point"]:
        scn = scn.with_(**{k: build_spec(rt, v)
                           for k, v in e["point"].items()})
    if scn.failures is not None:
        ft = scn.failures.materialize(int(scn.total_nodes))
        check(not ft.truncated and ft.n_failures == e["n_failures"],
              f"{e['name']}: failure stream truncated or resized")
    if hasattr(scn.trace, "plan"):
        plan = scn.trace.plan()
        check(not plan.truncated and plan.n_requests == e["n_requests"],
              f"{e['name']}: service trace truncated or resized")
    return scn


def check_stream_golden(out, e, what: str = "") -> None:
    """A run's n_events, makespan and digests against the JAX engine's: the
    valid rows of every per-job column the entry lists, and the whole
    capacity log and ev_lfb log."""
    v = out["valid"]
    whole = ("cap_online", "cap_time", "ev_lfb")
    got = {"n_jobs": int(v.sum()), "n_events": out["n_events"],
           "makespan": out["makespan"]}
    for k in e:
        if k.endswith("_sha256"):
            col = k[:-len("_sha256")]
            got[k] = digest(out[col] if col in whole else out[col][v])
    for k, want in got.items():
        check(want == e[k], f"{what}{e['name']}: {k} {want} != golden "
              f"{e[k]}")


def _results(e) -> dict:
    """The results of a golden entry (its digests, events and makespan)."""
    return {k: v for k, v in e.items()
            if k.endswith("_sha256") or k in ("n_events", "makespan")}


def stream_counts(engine, counts: dict) -> dict:
    """The stream counters of the run just made, beside its launch counts:
    entries consumed, kills by kind, device reads an entry, launches an
    event."""
    c = {k: engine.counters[k] for k in STREAM_KEYS}
    entries = c["failures"] + c["repairs"] + c["ticks"]
    c["stream_entries"] = entries
    c["reads_per_stream_entry"] = (c["stream_reads"] / entries if entries
                                   else "no entries")
    return {**counts, **c}


def stream_run(rt, ops, e, what: str = ""):
    """One run of a stream golden entry on cuda, held to it: ``(scenario,
    result, wall seconds, counts)`` with the per-run rates."""
    from repro_torch.core import engine
    scn = stream_scenario(rt, e)
    # a table with edges under a blocking policy and the free counter's
    # cap takes the prefix pass, which makes no selection
    edges = scn.trace.static_key()[0] == "workflow"
    out, wall, counts = run_counted(rt, ops, scn,
                                    selects=not (edges and prefix_pass(scn)))
    check_stream_golden(out, e, what)
    counts = stream_counts(engine, counts)
    n_jobs = int(out["valid"].sum())
    counts.update(events_per_s=out["n_events"] / wall,
                  jobs_per_s=n_jobs / wall)
    return scn, out, wall, counts


def phase_streams(rt, ops, golden_path, phase: str):
    """Every solo run of a stream golden file on cuda, each held to its
    JAX digests; returns the launch counts and each run's (events, wall
    seconds) by name."""
    t0 = time.time()
    launches = walks = 0
    solo = {}
    for e in json.loads(golden_path.read_text())["runs"]:
        scn, out, wall, counts = stream_run(rt, ops, e)
        launches += counts["launches"]
        walks += counts["walk_launches"]
        solo[e["name"]] = (out["n_events"], wall)
        emit(phase, t0, run=e["name"], policy=scn.policy,
             topology=None if scn.topology is None else
             [scn.topology.kind, list(scn.topology.shape)],
             alloc=scn.alloc, n_jobs=e["n_jobs"],
             n_failures=e.get("n_failures"),
             n_requests=e.get("n_requests"), n_events=out["n_events"],
             makespan=out["makespan"], run_seconds=wall, **counts,
             matches_jax=True)
    return {"launches": launches, "walk_launches": walks, "solo": solo}


def phase_stream_sweeps(torch, rt, ops, golden_path, phase: str,
                        solo=None):
    """Every sweep of a stream golden file through ``sweep`` on cuda: one
    bucket each, every member held to its solo run's JAX digests; the
    batch events/s beside the solo events/s of the members the solo phase
    ran in this call (``solo``: events and wall seconds by run name)."""
    from repro_torch.core import engine
    g = json.loads(golden_path.read_text())
    all_counts = []
    for sw in g["sweeps"]:
        t0 = time.time()
        members = sw["members"]
        base = build_spec(rt, sw["base"])
        axes = {k: [build_spec(rt, v) for v in vals]
                for k, vals in sw["axes"].items()}
        for m in members:      # every stream untruncated
            stream_scenario(rt, m)
        grid, outs, wall, counts = run_sweep(torch, rt, ops, base, axes,
                                             f"{phase} {sw['name']}")
        counts = stream_counts(engine, counts)
        check(grid.n_compiles == 1, f"{grid.n_compiles} buckets, expected 1")
        check(len(outs) == len(members), "sweep member count")
        for out, m in zip(outs, members):
            check_stream_golden(out, m, f"{phase} ")
        # the solo runs of this call that are members: the same results
        timed = sorted({r["name"] for r in g["runs"] for m in members
                        if _results(r) == _results(m)} & set(solo or ()))
        solo_eps = (sum(solo[k][0] for k in timed)
                    / sum(solo[k][1] for k in timed) if timed
                    else "not measured")
        ops.reset_launches()
        emit(phase, t0, sweep=sw["name"], axes=list(sw["axes"]),
             n_compiles=grid.n_compiles, members=len(grid),
             run_seconds=wall, **counts, solo_runs=timed,
             solo_events_per_s=solo_eps,
             batch_over_solo_rate=(counts["events_per_s"] / solo_eps
                                   if timed else "not measured"),
             matches_jax=True)
        all_counts.append(counts)
    return all_counts


# ---------------------------------------------------------------------------
# malleable jobs
# ---------------------------------------------------------------------------

MAL_KEYS = ("resize_ticks", "resize_reads", "resizes")


def mal_counts(engine, counts: dict) -> dict:
    """The resize counters of the run just made, beside its stream and
    launch counts: ticks consumed, reads a tick, resizes."""
    c = {k: engine.counters[k] for k in MAL_KEYS}
    c["resize_reads_per_tick"] = (c["resize_reads"] / c["resize_ticks"]
                                  if c["resize_ticks"] else "no ticks")
    return {**counts, **c}


def busy_share(torch, rt, scn, n_events: int):
    """The card's busy share of a profiled run of ``scn``'s first
    ``n_events`` events (its event cap set to that): device time over the
    run's wall time (which the profiler lengthens)."""
    cut = scn.with_(max_events=n_events)
    dev, wall_us = profiled(torch, lambda: rt.run(cut, device="cuda").to_np())
    busy_us = sum(us for _, us in dev.values())
    return busy_us / wall_us if dev else "not measured"


def phase_malleable(torch, rt, ops):
    """Malleable jobs solo on the card, each run held to its JAX digests
    (tests/data/torch_mal_golden.json): (a) des_throughput's moldable model
    on 5,000 SDSC-SP2-like jobs, backfill; (b) on its own 2,000-job
    trace, backfill and fcfs; (c) fig_malleable's elastic model on
    mesh2d(8, 16), backfill/contiguous and sjf/spread; (d) that model in
    scalar mode with the requeue failure model.  Per run events/s, jobs/s,
    resizes, device reads a tick, launches an event and the card's busy
    share (of a profiled prefix of the run)."""
    from repro_torch.core import engine
    launches = walks = 0
    solo = {}
    for e in json.loads(MAL_GOLDEN.read_text())["runs"]:
        t0 = time.time()
        scn, out, wall, counts = stream_run(rt, ops, e)
        counts = mal_counts(engine, counts)
        check(counts["resizes"] == e["n_resizes"],
              f"{e['name']}: {counts['resizes']} resizes counted, "
              f"{e['n_resizes']} in the result")
        if scn.malleable.mode == "elastic":
            check(counts["resizes"] > 0, f"{e['name']}: no resize")
        launches += counts["launches"]
        walks += counts["walk_launches"]
        solo[e["name"]] = (out["n_events"], wall)
        emit("malleable", t0, run=e["name"], policy=scn.policy,
             topology=None if scn.topology is None else
             [scn.topology.kind, list(scn.topology.shape)],
             alloc=scn.alloc, mode=scn.malleable.mode,
             max_ticks=scn.malleable.max_ticks
             if scn.malleable.mode == "elastic" else 0,
             n_jobs=e["n_jobs"], n_failures=e.get("n_failures"),
             n_events=out["n_events"], makespan=out["makespan"],
             run_seconds=wall, **counts,
             busy_share_of_prefix=busy_share(torch, rt, scn,
                                             MAL_PROFILE_EVENTS),
             profiled_events=MAL_PROFILE_EVENTS, matches_jax=True)
    return {"launches": launches, "walk_launches": walks, "solo": solo}


def phase_malleable_sweep(torch, rt, ops):
    """fig_malleable.py's full run through sweep: the rigid baselines and
    the moldable and elastic grids, one sweep and one bucket each, every
    member held to its JAX digests and to its solo run on the card."""
    from repro_torch.core import engine
    g = json.loads(MAL_GOLDEN.read_text())
    all_counts = []
    for sw in g["sweeps"]:
        t0 = time.time()
        base = build_spec(rt, sw["base"])
        axes = {k: [build_spec(rt, v) for v in vals]
                for k, vals in sw["axes"].items()}
        rt.reset_cache_stats()
        grid, outs, wall, counts = run_sweep(torch, rt, ops, base, axes,
                                             f"malleable_sweep {sw['name']}")
        counts = mal_counts(engine, stream_counts(engine, counts))
        stats = rt.cache_stats()
        check(grid.n_compiles == 1 and stats.compiles + stats.hits == 1,
              f"{grid.n_compiles} buckets, expected 1")
        check(len(outs) == len(sw["members"]), "sweep member count")
        solo_events = solo_wall = 0
        for out, m, res in zip(outs, sw["members"], grid.results):
            check_stream_golden(out, m, "malleable_sweep ")
            solo, s_wall, _ = run_counted(rt, ops, res.scenario)
            check_same(out, solo, f"malleable_sweep {m['name']}")
            solo_events += solo["n_events"]
            solo_wall += s_wall
        ops.reset_launches()
        emit("malleable_sweep", t0, sweep=sw["name"], axes=list(sw["axes"]),
             n_compiles=grid.n_compiles, cache_compiles=stats.compiles,
             cache_hits=stats.hits, members=len(grid), run_seconds=wall,
             **counts, solo_events_per_s=solo_events / solo_wall,
             batch_over_solo_rate=counts["events_per_s"]
             / (solo_events / solo_wall), matches_jax=True,
             members_equal_solo=True)
        all_counts.append(counts)
    return all_counts


def launch_counts(ops) -> dict:
    """The kernels' launch counters since the last ``reset_launches``:
    solo selections and walks, batched launches, the member-selections
    they served and batched walk launches."""
    return {"launches": ops.queue_select.launches,
            "walk_launches": ops.shadow_walk.launches,
            "batch_launches": ops.queue_select.batch_launches,
            "batch_selections": ops.queue_select.batch_selections,
            "walk_batch_launches": ops.shadow_walk.batch_launches}


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def windowed_run(rt, ops, scn, width: int):
    """``scn`` on cuda as rounds of ``simulate_window`` at ``t_hi = k x
    width`` while an event is due, then a drain at ``INF_TIME``, which
    must find nothing and not spin, with the one-shot run's event cap as
    the total: ``(result dict, wall seconds, rounds, counts)``.  No round
    may saturate."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.jobs import INF_TIME, SimState, result_from_state
    jobs = rt.api.build_jobset(scn, device="cuda")
    n = int(scn.total_nodes)
    cap = 6 * jobs.capacity + 8
    ops.reset_launches()
    t = time.time()
    state, rounds = SimState.init(jobs, n), 0
    while engine.next_event_time(jobs, state) < INF_TIME:
        rounds += 1
        state, sat = engine.simulate_window(scn.policy, jobs, state,
                                            rounds * width, cap)
        check(not sat, f"window round {rounds} saturated")
    n_events = state.n_events
    state, sat = engine.simulate_window(scn.policy, jobs, state, INF_TIME,
                                        cap)
    check(not sat and state.n_events == n_events,
          "the drain at INF_TIME found events or saturated")
    out = rt.api.simresult_to_np(result_from_state(jobs, state), jobs)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = launch_counts(ops)
    check(counts["launches"] > 0, "a windowed run launched no queue_select")
    return out, wall, rounds, counts


def phase_window(rt, ops, golden_runs=None):
    """The conservative window step, solo: (a) phase 4's backfill run
    (sdsc_sp2_like(10000, seed=1) on 128 nodes) as rounds of one simulated
    day, held to its golden digest, its events/s beside phase 4's
    one-shot run of this process (``golden_runs``, or run here); (b)
    phase 6f's scalar backfill run of the Galactic Plane DAG as rounds of
    100 s (releases cross rounds), held to its digest, between two
    one-shot runs of the same scenario (one-shot, windowed, one-shot):
    the stop test's cost, paired in time.  Each windowed run's launches
    equal the one-shot run's (the same decisions)."""
    t0 = time.time()
    total = {}
    e = next(e for e in json.loads(GOLDEN.read_text())["runs"]
             if (e["kind"], e["policy"]) == ("sdsc_sp2", "backfill"))
    scn = rt.Scenario(trace=rt.SyntheticTrace(
        n_jobs=e["n_jobs"], seed=e["seed"], kind=e["kind"]),
        total_nodes=e["total_nodes"], policy=e["policy"])
    d = next(d for d in json.loads(DAG_GOLDEN.read_text())["runs"]
             if d["policy"] == "backfill" and d["topology"] is None)
    phase4 = (None if golden_runs is None
              else golden_runs[("sdsc_sp2", "backfill")])
    for what, s, width, entry, check_fn, paired in (
            ("a", scn, WINDOW_DAY, e, check_golden, False),
            ("b", dag_scenario(rt, d), WINDOW_DAG, d, check_dag_golden,
             True)):
        if what == "a" and phase4 is not None:
            ones = [phase4]
        else:
            o, w, c = run_counted(rt, ops, s)
            ones = [(o["n_events"], w, c)]
        out, wall, rounds, counts = windowed_run(rt, ops, s, width)
        if paired:
            o, w, c = run_counted(rt, ops, s)
            ones.append((o["n_events"], w, c))
        check_fn(out, entry, f"window ({what}): ")
        add_counts(total, counts)
        for k in ("launches", "walk_launches"):
            check(counts[k] == ones[0][2][k], f"window ({what}): {k} "
                  f"{counts[k]} != the one-shot run's {ones[0][2][k]}")
        one = [n / w for n, w, _ in ones]
        rate = out["n_events"] / wall
        emit("window", t0, run=what, n_jobs=int(out["valid"].sum()),
             policy="backfill", width=width, rounds=rounds,
             n_events=out["n_events"], run_seconds=wall,
             events_per_s=rate, one_shot_events_per_s=one,
             one_shot=("before and after" if paired
                       else "phase 4's" if phase4 is not None
                       else "before"),
             over_one_shot=rate / statistics.mean(one), saturated=False,
             **counts, matches_jax=True)
    return total


def mc_scenario(rt, kind: str, migrate: bool = True):
    """A multicluster scenario of tests/data/torch_multicluster_golden.json
    (``kind``: das2 or mixed)."""
    traces = [rt.SyntheticTrace(kind="das2", n_jobs=MC_JOBS, seed=50 + c)
              for c in range(len(MC_NODES))]
    if kind == "mixed":
        traces[0] = rt.WorkflowTrace(kind="galactic", params=(
            ("tiles", 16), ("width", 12)))
    return rt.Scenario(trace=tuple(traces), total_nodes=MC_NODES,
                       policy="backfill", multicluster=rt.Multicluster(
                           window=MC_WINDOW, migrate=migrate))


def mc_run(rt, ops, scn):
    """One multicluster run on cuda: ``(result dict, wall seconds,
    counts)``, with the rounds (window calls, the drain included), the
    lockstep events, the exchanges' host seconds, the batched launches and
    the member-selections a launch."""
    import torch
    from repro_torch.core import engine, parallel
    spent = {"exchange_s": 0.0, "windows": 0}
    exchange, window = parallel._exchange, engine.simulate_window_batch

    def timed_exchange(*a, **k):
        t = time.time()
        try:
            return exchange(*a, **k)
        finally:
            spent["exchange_s"] += time.time() - t

    def counted_window(*a, **k):
        spent["windows"] += 1
        return window(*a, **k)

    parallel._exchange = timed_exchange
    engine.simulate_window_batch = counted_window
    ops.reset_launches()
    try:
        t = time.time()
        res = rt.run(scn, device="cuda")
        out = res.to_np()
        torch.cuda.synchronize()
        wall = time.time() - t
    finally:
        parallel._exchange, engine.simulate_window_batch = exchange, window
    counts = launch_counts(ops)
    check(counts["batch_launches"] > 0,
          "a multicluster run launched no batched queue_select")
    check(counts["walk_batch_launches"] > 0,
          "a backfill multicluster run launched no batched walk")
    events = sum(res.raw.state.n_events)
    counts.update(rounds=spent["windows"], lockstep_events=events,
                  events_per_s=events / wall,
                  exchange_s=spent["exchange_s"],
                  member_selections_per_launch=(
                      counts["batch_selections"] / counts["batch_launches"]))
    return out, wall, counts


def check_mc_golden(out, e, what: str) -> None:
    got = {"n_jobs": int(out["valid"].sum()), "migrated": out["migrated"],
           "dropped": out["dropped"], "saturated": out["saturated"],
           "makespan": out["makespan"]}
    for k in ("start", "finish"):
        got[f"{k}_sha256"] = digest(out[k])
    for k in ("valid", "done"):   # one byte a row
        got[f"{k}_sha256"] = hashlib.sha256(
            out[k].astype("uint8").tobytes()).hexdigest()
    for k, want in got.items():
        check(want == e[k], f"multicluster {what}: {k} {want} != golden "
              f"{e[k]}")


def phase_multicluster(rt, ops, np):
    """DAS-2's five clusters, backfill, Multicluster(window=3600): the run
    with migration and the mixed grid (the Galactic Plane DAG on the first
    cluster) held to their JAX digests; the run without migration equal,
    cluster by cluster, to each cluster's solo one-shot run, and timed
    against them."""
    t0 = time.time()
    golden = {e["run"]: e for e in json.loads(MC_GOLDEN.read_text())["runs"]}
    total = {}
    for kind in ("das2", "mixed"):
        out, wall, counts = mc_run(rt, ops, mc_scenario(rt, kind))
        check_mc_golden(out, golden[kind], kind)
        add_counts(total, {k: counts[k] for k in launch_counts(ops)})
        emit("multicluster", t0, run=kind, clusters=list(MC_NODES),
             n_jobs=int(out["valid"].sum()), window=MC_WINDOW,
             migrated=out["migrated"], dropped=out["dropped"],
             saturated=out["saturated"], makespan=out["makespan"],
             run_seconds=wall, **counts, matches_jax=True)
    scn = mc_scenario(rt, "das2", migrate=False)
    out, wall, counts = mc_run(rt, ops, scn)
    add_counts(total, {k: counts[k] for k in launch_counts(ops)})
    solo_wall = 0.0
    for c, (spec, n) in enumerate(zip(scn.trace_specs(), MC_NODES)):
        one = rt.Scenario(trace=spec, total_nodes=n, policy="backfill",
                          capacity=MC_JOBS)
        o, w, cnt = run_counted(rt, ops, one)
        solo_wall += w
        add_counts(total, {k: cnt[k] for k in ("launches",
                                               "walk_launches")})
        sl = slice(c * MC_JOBS, (c + 1) * MC_JOBS)
        for k in ("start", "finish"):
            check(bool(np.array_equal(out[k][sl], o[k])),
                  f"multicluster without migration: cluster {c} {k} "
                  "differs from its solo run")
    emit("multicluster", t0, run="das2 without migration",
         run_seconds=wall, **counts, solo_runs_seconds=solo_wall,
         lockstep_over_solo=solo_wall / wall, equals_solo_runs=True)
    return total


def phase_replay(rt, ops, np):
    """Half benchmarks/replay_smoke.py's smoke size on the card: a
    10,000-job synthetic archive written by dump_swf and read back by
    load_swf,
    replayed under backfill on 128 nodes at window 4,096 (every job done
    or aborted, peak_live <= window); then its 4,000-job prefix at window
    512: a kill after round 2 and a resume identical to the straight
    replay, which equals the port's replay_reference."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.refsim import replay_reference
    from repro_torch.replay import (
        ReplayInterrupted, StreamingReplay, replay_trace, resume,
    )
    from repro_torch.traces import dump_swf, load_swf, synthetic_trace
    t0 = time.time()
    total = {}
    trace = synthetic_trace(REPLAY_JOBS, seed=3, mean_interarrival=220.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "synthetic.swf.gz")
        t = time.time()
        check(dump_swf(path, trace) == REPLAY_JOBS, "dump_swf row count")
        loaded, rep = load_swf(path, rebase=False)
        io_s = time.time() - t
    check(rep.n_jobs == REPLAY_JOBS and rep.n_quarantined == 0,
          rep.summary())
    for k in ("submit", "runtime", "nodes", "estimate"):
        check(bool(np.array_equal(np.asarray(trace[k], np.int64),
                                  loaded[k])), f"SWF round trip: {k}")
    kw = dict(total_nodes=REPLAY_NODES, device="cuda")
    ops.reset_launches()
    t = time.time()
    full = replay_trace(loaded, "backfill", window=REPLAY_WINDOW, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = launch_counts(ops)
    check(counts["launches"] > 0, "the replay launched no queue_select")
    add_counts(total, counts)
    s = full.summary()
    check(s["n_done"] + s["n_aborted"] == REPLAY_JOBS, f"replay: {s}")
    check(s["peak_live"] <= s["window"], f"replay: {s}")
    emit("replay", t0, run="archive", n_jobs=REPLAY_JOBS,
         window=REPLAY_WINDOW, swf_round_trip_s=io_s, run_seconds=wall,
         jobs_per_s=REPLAY_JOBS / wall, events_per_s=s["n_events"] / wall,
         rounds=s["n_rounds"], peak_live=s["peak_live"],
         n_events=s["n_events"], flags=s["flags"], **counts)
    pfx = {k: v[:REPLAY_PREFIX] for k, v in loaded.items()}
    kw["window"] = REPLAY_PREFIX_WINDOW
    ops.reset_launches()
    t = time.time()
    straight = replay_trace(dict(pfx), "backfill", **kw)
    straight_s = time.time() - t
    add_counts(total, launch_counts(ops))
    t = time.time()
    with tempfile.TemporaryDirectory() as ckpt:
        try:
            StreamingReplay(dict(pfx), "backfill", ckpt_dir=ckpt,
                            ckpt_every=1, _crash_after_round=2, **kw).run()
            check(False, "the crash hook never fired")
        except ReplayInterrupted:
            pass
        resumed = resume(ckpt, dict(pfx), "backfill", **kw)
    kill_s = time.time() - t
    for f in dataclasses.fields(straight):
        a, b = getattr(straight, f.name), getattr(resumed, f.name)
        same = (bool(np.array_equal(a, b)) if isinstance(a, np.ndarray)
                else a == b)
        check(same, f"resume differs from the straight replay: {f.name}")
    t = time.time()
    ref = replay_reference(dict(pfx), "backfill", total_nodes=REPLAY_NODES)
    oracle_s = time.time() - t
    d = straight.done
    for k, a, b in (("start", straight.start, ref["start"]),
                    ("finish", straight.finish[d], ref["finish"][ref["done"]]),
                    ("wait", straight.wait[d], ref["wait"][ref["done"]]),
                    ("done", d, ref["done"])):
        check(bool(np.array_equal(a, b)), f"replay prefix: {k} differs "
              "from replay_reference")
    check(straight.n_events == int(ref["n_events"]),
          "replay prefix: n_events differs from replay_reference")
    emit("replay", t0, run="prefix", n_jobs=REPLAY_PREFIX,
         window=REPLAY_PREFIX_WINDOW, run_seconds=straight_s,
         jobs_per_s=REPLAY_PREFIX / straight_s,
         events_per_s=straight.n_events / straight_s,
         rounds=straight.n_rounds, peak_live=straight.peak_live,
         flags=straight.flags.as_dict(), kill_resume_s=kill_s,
         resume_identical=True, oracle_s=oracle_s, matches_oracle=True)
    return total


def flash_check(torch, ops, ref, q, k, v, causal, window, tol) -> float:
    """One kernel call against the plain version; the largest error."""
    kw = dict(causal=causal, window=window, q_offset=k.shape[1] - q.shape[1])
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.attention_reference(q, k, v, **kw).float()
    d = (got.float() - want).abs()
    bad = int((d > tol + tol * want.abs()).sum())
    check(bad == 0 and got.dtype == q.dtype and bool(torch.isfinite(got).all()),
          f"flash_attention {q.dtype} q {tuple(q.shape)} k {tuple(k.shape)} "
          f"{kw}: {bad} entries off by up to {float(d.max())}")
    return float(d.max())


def phase_flash(torch, np):
    from repro_torch.kernels.flash_attention import ops, ref
    t0 = time.time()
    rng = np.random.default_rng(0)
    ops.reset_launches()
    n_checks = dict.fromkeys(FLASH_TOL, 0)
    max_err = dict.fromkeys(FLASH_TOL, 0.0)
    cases = [(shape, FLASH_TOL, FLASH_MASKS) for shape in FLASH_SHAPES]
    cases += [(shape, {"bfloat16": FLASH_TOL["bfloat16"]}, masks)
              for shape, masks in FLASH_BF16_CASES]
    for (B, Sq, Sk, H, KV, hd), tols, masks in cases:
        base = [rng.standard_normal((B, s, n, hd), dtype=np.float32)
                for s, n in ((Sq, H), (Sk, KV), (Sk, KV))]
        for dtype, tol in tols.items():
            q, k, v = (torch.from_numpy(a).to("cuda", getattr(torch, dtype))
                       for a in base)
            for causal, window in masks:
                err = flash_check(torch, ops, ref, q, k, v, causal, window, tol)
                max_err[dtype] = max(max_err[dtype], err)
                n_checks[dtype] += 1
    # every bf16 call on the tensor-core kernel, every f32 call on the other
    by_route = dict(ops.flash_attention.launches_by_route)
    check(by_route == {"sm90_bf16": n_checks["bfloat16"],
                       "f32": n_checks["float32"]},
          f"flash_attention routes {by_route} for checks {n_checks}")
    del q, k, v

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
    q32, k32, v32 = (x.float() for x in (q, k, v))
    f32_ms = time_ms(lambda: ops.flash_attention(q32, k32, v32, causal=True),
                     FLASH_TIMED)
    del q32, k32, v32
    # 4 hd flops (q.k and p.v) for each (query, key) pair the causal mask
    # leaves: S (S + 1) / 2 of them for each (batch, head)
    flops = 4 * hd * B * H * (S * (S + 1) // 2)
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    ops_ms, bytes_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    del q, k, v, qt, kt, vt

    # the hd-80 shape (stablelm-3b's heads), causal
    B8, S8, _, H8, KV8, hd8 = FLASH_HD80
    q, k, v = (torch.randn((B8, S8, n, hd8), device="cuda",
                           dtype=torch.bfloat16) for n in (H8, KV8, KV8))
    hd80_ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                      FLASH_TIMED)
    hd80_flops = 4 * hd8 * B8 * H8 * (S8 * (S8 + 1) // 2)
    del q, k, v
    ops.reset_launches()
    timing = {"shape": f"B={B} Sq=Sk={S} H={H} KV={KV} hd={hd} bf16 causal",
              "kernel_ms": kernel_ms, "f32_ms": f32_ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "library_call": "F.scaled_dot_product_attention(is_causal=True, "
                              "enable_gqa=True) on [B, heads, S, hd] views",
              "flops": flops, "bytes": nbytes,
              "bound_ms": max(ops_ms, bytes_ms),
              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
              "share_of_bound": max(ops_ms, bytes_ms) / kernel_ms,
              "tflops": flops / kernel_ms / 1e9,
              "f32_tflops": flops / f32_ms / 1e9,
              "hd80_shape": "B={} Sq=Sk={} H={} KV={} hd={} bf16 causal".format(
                  B8, S8, H8, KV8, hd8),
              "hd80_ms": hd80_ms, "hd80_tflops": hd80_flops / hd80_ms / 1e9}
    emit("flash", t0, checks=n_checks, launches_by_route=by_route, tf32=False,
         max_abs_err_f32=max_err["float32"],
         max_abs_err_bf16=max_err["bfloat16"], **timing)
    return max(max_err.values()), timing


def phase_lm_golden(torch, np, arch="llama3.2-3b", phase="lm_golden"):
    """A reduced model, f32, on the kernel path: the JAX package's prefill
    logits and generated tokens, from its entry of the golden file."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.linattn_scan.ops import linattn
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm
    t0 = time.time()
    g, = [e for e in json.loads(LM_GOLDEN.read_text()) if e["arch"] == arch]
    cfg = dataclasses.replace(get_config(g["arch"]).reduced(), use_pallas=True)
    op = linattn if cfg.family == "rwkv" else flash_attention
    params = lm_params_from_numpy(numpy_lm_params(
        cfg, g["seed"], live_seed=g.get("live_seed")), "cuda")
    before = op.launches
    last, _ = lm.prefill(
        params, {"tokens": torch.tensor(g["prompts"], device="cuda")}, cfg)
    check(op.launches == before + cfg.n_layers,
          "the golden prefill did not run the kernel in every layer")
    last = last.cpu().numpy()
    err = float(np.abs(last - np.asarray(g["last_logits"])).max())
    check(np.allclose(last, g["last_logits"], atol=LM_TOL, rtol=LM_TOL),
          f"golden prefill logits off by {err}")
    seqs, _ = serve_batch(cfg, g["batch"], g["prompt_len"], g["gen"],
                          seed=g["seed"], params=params, device="cuda")
    check(seqs.tolist() == g["tokens"], "golden tokens differ from JAX's")
    op.launches = 0
    emit(phase, t0, arch=g["arch"], reduced=True, dtype=cfg.dtype,
         batch=g["batch"], prompt_len=g["prompt_len"], gen=g["gen"],
         live_leaves=g.get("live_seed") is not None,
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
        ops.reset_launches()
        seqs, stats = serve_batch(cfg, **SERVE, seed=0, params=params,
                                  device="cuda")
        launches = ops.flash_attention.launches
        by_route = dict(ops.flash_attention.launches_by_route)
        check(launches == base.n_layers
              and by_route == {"sm90_bf16": base.n_layers, "f32": 0},
              f"serve launched flash_attention {launches} times by route "
              f"{by_route}, expected {base.n_layers}, all sm90_bf16")
        out = seqs.cpu().numpy()
        total = SERVE["prompt_len"] + SERVE["gen"]
        check(out.shape == (SERVE["batch"], total)
              and (out[:, :SERVE["prompt_len"]] == prompts).all()
              and ((out >= 0) & (out < base.vocab)).all(),
              "serve returned malformed sequences")
        emit("serve", t0, run=run, arch=base.name, dtype=cfg.dtype,
             **SERVE, n_params=model.n_params(), flash_launches=launches,
             flash_launches_by_route=by_route,
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
    profile_serve(torch, "serve_profile", "flash",
                  lambda: lm.prefill(params, batch, cfg), step)
    ops.reset_launches()
    return launches


def profile_serve(torch, phase, kernel, prefill, step) -> None:
    """One profiled prefill and one profiled decode step: top device
    operations, the device's busy share, the kernel's share (by the name
    of its CUDA function, ``<kernel>_fwd``)."""
    for name, fn in (("prefill", prefill), ("decode_step", step)):
        t0 = time.time()
        dev, wall_us = profiled(torch, fn)
        busy_us = sum(us for _, us in dev.values())
        kernel_us = sum(us for n, (_, us) in dev.items()
                        if f"{kernel}_fwd" in n)
        top = sorted(dev.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
        emit(phase, t0, what=name, wall_s=wall_us / 1e6,
             device_busy_s=busy_us / 1e6,
             device_busy_share=busy_us / wall_us if dev else "not measured",
             device_events=sum(k for k, _ in dev.values()),
             **{f"{kernel}_device_s": kernel_us / 1e6,
                f"{kernel}_share_of_device": kernel_us / busy_us if dev
                else "not measured"},
             top_device_us={n[:60]: us for n, (_, us) in top})


def linattn_logw(np, rng, shape, logw):
    """f32 log decays: -exp(N(0, 0.5^2)) for None, a constant, or "mixed"
    (each channel's own scale, log-uniform from 1e-6 to 30)."""
    if logw is None:
        return -np.exp(rng.standard_normal(shape, dtype=np.float32) * 0.5)
    if logw == "mixed":
        scale = np.exp(rng.uniform(np.log(1e-6), np.log(30.0), shape[-1]))
        return (-scale * np.exp(rng.standard_normal(shape) * 0.3)
                ).astype(np.float32)
    return np.full(shape, logw, np.float32)


def phase_linattn(torch, np):
    from repro_torch.kernels.linattn_scan import ops, ref
    t0 = time.time()
    rng = np.random.default_rng(0)
    n_checks, max_err = 0, dict.fromkeys(LINATTN_TOL, 0.0)
    max_rel = dict.fromkeys(LINATTN_TOL, 0.0)
    want_routes = dict.fromkeys(ops.ROUTES, 0)
    ops.reset_launches()
    cases = [(c, LINATTN_TOL) for c in LINATTN_CASES]
    cases += [(c, {"bfloat16": LINATTN_TOL["bfloat16"]})
              for c in LINATTN_BF16_CASES]
    for (B, H, S, K, logw), tols in cases:
        base = [rng.standard_normal((B, H, S, K), dtype=np.float32) * 0.5
                for _ in range(3)]
        lw = torch.from_numpy(linattn_logw(np, rng, (B, H, S, K), logw)
                              ).to("cuda")
        u = torch.from_numpy(rng.standard_normal((H, K), dtype=np.float32)
                             * 0.5).to("cuda")
        for dtype, tol in tols.items():
            r, k, v = (torch.from_numpy(a).to("cuda", getattr(torch, dtype))
                       for a in base)
            y, st = ops.linattn(r, k, v, lw, u, return_state=True)
            wy, wst = ref.linattn_reference(r, k, v, lw, u)
            d = (y.float() - wy.float()).abs().max().item()
            ds = (st - wst).abs().max().item()
            ey = d / (wy.float().abs().max().item() + 1e-6)
            es = ds / (wst.abs().max().item() + 1e-6)
            check(y.dtype == r.dtype and st.dtype == torch.float32
                  and bool(torch.isfinite(y).all())
                  and ey < tol and es < LINATTN_TOL["float32"],
                  f"linattn {dtype} {(B, H, S, K)} logw={logw}: y off by "
                  f"{ey} of its largest entry, state by {es}")
            max_err[dtype] = max(max_err[dtype], d)
            max_rel[dtype] = max(max_rel[dtype], ey, es)
            want_routes[ops.route(r.dtype, K)] += 1
            n_checks += 1
    del r, k, v, y, st, wy, wst, lw
    by_route = dict(ops.linattn.launches_by_route)
    check(by_route == want_routes and ops.linattn.launches == n_checks,
          f"linattn routes {by_route}, expected {want_routes}")

    # timing at the serve shape, in the model's layout: bf16 r/k/v and f32
    # logw as [B, H, S, K] views of [B, S, H, K] tensors
    B, H, S, K = 4, 64, RWKV_SERVE["prompt_len"], 64
    r, k, v = (0.5 * torch.randn((B, S, H, K), device="cuda",
                                 dtype=torch.bfloat16) for _ in range(3))
    lw = -torch.exp(0.5 * torch.randn((B, S, H, K), device="cuda"))
    r, k, v, lw = (x.transpose(1, 2) for x in (r, k, v, lw))
    u = 0.5 * torch.randn((H, K), device="cuda")
    y, st = ops.linattn(r, k, v, lw, u, return_state=True)
    wy, wst = ref.linattn_reference(r, k, v, lw, u)
    check(float((y.float() - wy.float()).abs().max()
                / wy.float().abs().max()) < LINATTN_TOL["bfloat16"]
          and float((st - wst).abs().max() / wst.abs().max())
          < LINATTN_TOL["float32"], "linattn at the serve shape, model layout")
    check(ops.linattn.launches_by_route["sm90_bf16"] == by_route["sm90_bf16"] + 1,
          "linattn at the serve shape did not take the sm90 route")
    del y, st, wy, wst
    kernel_ms = time_ms(lambda: ops.linattn(r, k, v, lw, u, return_state=True),
                        LINATTN_TIMED)
    # the CUDA-core kernel on the same bf16 inputs (its route takes bf16
    # only at K 16 and 32 now; the launcher is called directly)
    y, st = torch.empty_like(r), torch.empty((B, H, K, K), device="cuda")
    cuda_core_ms = time_ms(
        lambda: ops._launch_cuda_core(r, k, v, lw, u, y, st), LINATTN_TIMED)
    del y, st
    plain_ms = time_ms(lambda: ref.linattn_reference(r, k, v, lw, u),
                       LINATTN_PLAIN_TIMED, warm=1)
    # each input read once, y and the state written once; the recurrence's
    # least arithmetic, 4 K^2 flops a step and head (r.S, and the decay and
    # rank-1 update of S), at the bf16 tensor-core rate that the sm90
    # kernel runs its products at; the CUDA-core kernel's bound takes them
    # at the f32 rate outside the tensor cores
    nbytes = (3 * r.numel() * r.element_size() + lw.numel() * lw.element_size()
              + u.numel() * 4 + r.numel() * r.element_size() + B * H * K * K * 4)
    flops = 4 * K * K * B * H * S
    ops_ms, bytes_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    f32_ops_ms = flops / F32_FLOPS * 1e3
    # what the Pallas kernel's chunk form does at its chunk of 128, for
    # comparison: 7 Q^2 K + 4 Q K^2 flops and Q^2 K exponentials a chunk
    Q = 128
    chunks = B * H * -(-S // Q)
    ops.reset_launches()
    timing = {"shape": f"B={B} H={H} S={S} K={K} r/k/v bf16 logw f32, "
                       "[B, S, H, K] layout",
              "kernel_ms": kernel_ms, "cuda_core_ms": cuda_core_ms,
              "plain_ms": plain_ms,
              "library_ms": None,
              "library_call": "none: no PyTorch call computes WKV6",
              "flops": flops, "bytes": nbytes,
              "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
              "bytes_ms": bytes_ms,
              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
              "f32_ops_ms": f32_ops_ms,
              "cuda_core_bound_ms": max(f32_ops_ms, bytes_ms),
              "pallas_chunk_form_flops": chunks * (7 * Q * Q * K + 4 * Q * K * K),
              "pallas_chunk_form_exps": chunks * Q * Q * K}
    emit("linattn", t0, checks=n_checks, launches_by_route=by_route,
         tf32=False,
         max_abs_err_f32=max_err["float32"],
         max_abs_err_bf16=max_err["bfloat16"],
         max_rel_err_f32=max_rel["float32"],
         max_rel_err_bf16=max_rel["bfloat16"], **timing)
    return max(max_err.values()), timing


def rwkv_full_width(torch, np):
    """rwkv6-7b at full width with random weights from seed 0 (``mu``,
    ``u`` and ``w0`` drawn live), and phase 12a's prompt of CHECK_LEN
    tokens: ``(config, model, params, tokens)``."""
    from repro_torch.configs import get_config
    from repro_torch.convert import set_rwkv_live_leaves
    from repro_torch.models.api import get_model
    base = get_config("rwkv6-7b")
    model = get_model(base)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    set_rwkv_live_leaves(params.tree(), base, RWKV_LIVE_SEED)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, base.vocab - 1, (1, CHECK_LEN))).to("cuda")
    return base, model, params, toks


def bf16_prefill_errs(np, params, cfg, toks, want, wstate):
    """A prefill of ``cfg`` against the plain path's logits ``want`` (numpy)
    and final WKV states ``wstate``: ``(logits error over the largest
    logit, states error over the largest state entry, argmax equal,
    logits)``."""
    from repro_torch.models import lm
    got, gc = lm.prefill(params, {"tokens": toks}, cfg)
    state_err = float((gc["wkv"] - wstate).abs().max() / wstate.abs().max())
    got = got.float().cpu().numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    return (err, state_err, bool((got.argmax(-1) == want.argmax(-1)).all()),
            got)


def phase_rwkv_serve(torch, np):
    import dataclasses
    from repro_torch.kernels.linattn_scan import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm
    torch.cuda.empty_cache()        # the llama weights are gone by now
    t0 = time.time()
    base, model, params, toks = rwkv_full_width(torch, np)

    # (a) f32 at full width: the kernel path against the plain path
    cfg32 = dataclasses.replace(base, dtype="float32", use_pallas=True)
    got, gc = lm.prefill(params, {"tokens": toks}, cfg32)
    want, wc = lm.prefill(params, {"tokens": toks},
                          dataclasses.replace(cfg32, use_pallas=False))
    state_err = float((gc["wkv"] - wc["wkv"]).abs().max()
                      / wc["wkv"].abs().max())
    got, want = got.cpu().numpy(), want.cpu().numpy()
    err = float(np.abs(got - want).max())
    check(bool(np.isfinite(got).all()) and got.shape == (1, base.vocab)
          and tuple(gc["wkv"].shape) == (base.n_layers, 1, base.d_model // 64,
                                         64, 64),
          "full-width f32 rwkv prefill: logits or state not finite or "
          "misshapen")
    check(np.allclose(got, want, atol=CHECK_TOL, rtol=CHECK_TOL),
          f"full-width f32 rwkv prefill: kernel path off the plain path by "
          f"{err}")
    check(state_err < CHECK_TOL, f"full-width f32 rwkv prefill: final WKV "
          f"states off the plain path's by {state_err} of their largest entry")
    emit("rwkv_serve_check", t0, arch=base.name, dtype="float32",
         prompt_len=CHECK_LEN, live_leaves=True, max_abs_err=err,
         tol=CHECK_TOL, max_abs_logit=float(np.abs(want).max()),
         state_max_rel_err=state_err,
         argmax_equal=bool((got.argmax(-1) == want.argmax(-1)).all()))
    del gc, wc

    # (a') the same prompt in bf16: the sm90 kernel against the plain path
    t0 = time.time()
    cfg16 = dataclasses.replace(base, use_pallas=True)
    want, wc = lm.prefill(params, {"tokens": toks},
                          dataclasses.replace(cfg16, use_pallas=False))
    want, wstate = want.float().cpu().numpy(), wc["wkv"]
    ops.reset_launches()
    err, state_err, argmax_equal, got = bf16_prefill_errs(
        np, params, cfg16, toks, want, wstate)
    check(ops.linattn.launches_by_route == {"sm90_bf16": base.n_layers,
                                            "cuda_core": 0},
          f"bf16 rwkv prefill routes {ops.linattn.launches_by_route}")
    # yardstick, not checked: the CUDA-core kernel (f32 math, y rounded
    # once) on the same bf16 prefill, its route forced for this call only
    route = ops.route
    ops.route = lambda dtype, K: "cuda_core"
    try:
        core_err, core_state_err, _, _ = bf16_prefill_errs(
            np, params, cfg16, toks, want, wstate)
    finally:
        ops.route = route
    check(bool(np.isfinite(got).all()) and got.shape == (1, base.vocab),
          "full-width bf16 rwkv prefill logits not finite or misshapen")
    check(err < BF16_LOGIT_TOL and state_err < BF16_STATE_TOL,
          f"full-width bf16 rwkv prefill: kernel path off the plain path by "
          f"{err} of the largest logit (limit {BF16_LOGIT_TOL}), states by "
          f"{state_err} (limit {BF16_STATE_TOL})")
    ops.reset_launches()
    emit("rwkv_serve_check", t0, arch=base.name, dtype="bfloat16",
         prompt_len=CHECK_LEN, live_leaves=True, max_rel_err=err,
         tol=BF16_LOGIT_TOL, state_tol=BF16_STATE_TOL,
         max_abs_logit=float(np.abs(want).max()),
         state_max_rel_err=state_err, argmax_equal=argmax_equal,
         cuda_core_max_rel_err=core_err,
         cuda_core_state_max_rel_err=core_state_err)
    del wc, wstate

    # (b) the bf16 serve through serve_batch, twice (cold, then warm)
    t0 = time.time()
    cfg = dataclasses.replace(base, use_pallas=True)
    prompts = np.random.default_rng(0).integers(
        1, base.vocab - 1, (RWKV_SERVE["batch"], RWKV_SERVE["prompt_len"]))
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        seqs, stats = serve_batch(cfg, **RWKV_SERVE, seed=0, params=params,
                                  device="cuda")
        launches = ops.linattn.launches
        by_route = dict(ops.linattn.launches_by_route)
        check(launches == base.n_layers
              and by_route == {"sm90_bf16": base.n_layers, "cuda_core": 0},
              f"serve launched linattn_scan {launches} times by route "
              f"{by_route}, expected {base.n_layers}, all sm90_bf16")
        out = seqs.cpu().numpy()
        total = RWKV_SERVE["prompt_len"] + RWKV_SERVE["gen"]
        check(out.shape == (RWKV_SERVE["batch"], total)
              and (out[:, :RWKV_SERVE["prompt_len"]] == prompts).all()
              and ((out >= 0) & (out < base.vocab)).all(),
              "rwkv serve returned malformed sequences")
        emit("rwkv_serve", t0, run=run, arch=base.name, dtype=cfg.dtype,
             **RWKV_SERVE, n_params=model.n_params(), live_leaves=True,
             linattn_launches=launches, linattn_launches_by_route=by_route,
             prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
             decode_tok_per_s=stats["decode_tok_per_s"],
             total_tok_per_s=stats["tok_per_s"], seconds=stats["seconds"],
             prefill_tok_per_s=RWKV_SERVE["batch"] * RWKV_SERVE["prompt_len"]
             / stats["prefill_s"],
             max_memory_allocated=torch.cuda.max_memory_allocated())

    # (c) one profiled prefill and one profiled decode step
    batch = {"tokens": torch.from_numpy(prompts).to("cuda")}
    _, cache = lm.prefill(params, batch, cfg)
    tok = seqs[:, RWKV_SERVE["prompt_len"]]
    step = lambda: lm.decode_step(params, tok, RWKV_SERVE["prompt_len"],  # noqa: E731
                                  cache, cfg)
    step()                                     # warm
    profile_serve(torch, "rwkv_serve_profile", "linattn",
                  lambda: lm.prefill(params, batch, cfg), step)
    ops.reset_launches()
    return launches


PHASES = ("kernel", "fused", "batched", "golden", "archive", "profile",
          "sweep", "ensemble", "alloc", "alloc_sweep", "dag", "dag_sweep",
          "workflow", "workflow_batch", "reliability", "reliability_sweep",
          "serving", "serving_sweep", "malleable", "malleable_sweep",
          "oracle", "window", "multicluster", "replay", "flash",
          "lm_golden", "serve", "linattn", "rwkv_golden", "rwkv_serve")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", type=lambda a: a.split(","), default=None,
                    help="comma-separated phases to run after env and build "
                         f"(of {', '.join(PHASES)}); a rehearsal")
    only = ap.parse_args(argv).only
    if only is not None and not set(only) <= set(PHASES):
        ap.error(f"unknown phases {sorted(set(only) - set(PHASES))}")
    t_all = time.time()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not ((ROOT / "src" / "repro_torch").is_dir() and all(
            g.exists() for g in (GOLDEN, LM_GOLDEN, ALLOC_GOLDEN, DAG_GOLDEN,
                                 DAG_SWEEP_GOLDEN, WORKFLOW_GOLDEN,
                                 REL_GOLDEN, SERVING_GOLDEN, MAL_GOLDEN,
                                 MC_GOLDEN))):
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
    ptxas = {src: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln or "smem" in ln]
             for src, log in logs.items()}
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.linattn_scan import ops as lops
    emit("build", t0, sources=list(logs), ptxas=ptxas,
         sm90_flash_dynamic_smem_bytes={
             hd: fops.sm90_smem_bytes(hd) for hd in fops.HEAD_DIMS},
         sm90_linattn_dynamic_smem_bytes={
             K: lops.sm90_smem_bytes(K) for K in lops.SM90_KEY_DIMS})

    phases = {
        "kernel": lambda: phase_kernel(torch, np, ops, ref),
        "fused": lambda: phase_fused(torch, np, ops, ref),
        "batched": lambda: phase_batched(torch, np, ops, ref),
        "golden": lambda: phase_golden(rt, ops),
        "archive": lambda: phase_archive(rt, ops, np),
        "profile": lambda: phase_profile(torch, rt),
        "sweep": lambda: phase_sweep(torch, rt, ops),
        "ensemble": lambda: phase_ensemble(torch, rt, ops),
        "alloc": lambda: phase_alloc(
            torch, rt, ops, out["golden"][2] if "golden" in out else None),
        "alloc_sweep": lambda: phase_alloc_sweep(
            torch, rt, ops, out["alloc"]["solo"] if "alloc" in out else None),
        "dag": lambda: phase_dag(
            rt, ops, out["golden"][2] if "golden" in out else None),
        "dag_sweep": lambda: phase_dag_sweep(
            torch, rt, ops, out["dag"]["solo"] if "dag" in out else None),
        "workflow": lambda: phase_workflow(torch, np, rt, ops),
        "workflow_batch": lambda: phase_workflow_batch(
            torch, np, rt, ops,
            out["workflow"][1] if "workflow" in out else None),
        "reliability": lambda: phase_streams(rt, ops, REL_GOLDEN,
                                             "reliability"),
        "reliability_sweep": lambda: phase_stream_sweeps(
            torch, rt, ops, REL_GOLDEN, "reliability_sweep",
            out["reliability"]["solo"] if "reliability" in out else None),
        "serving": lambda: phase_streams(rt, ops, SERVING_GOLDEN, "serving"),
        "serving_sweep": lambda: phase_stream_sweeps(
            torch, rt, ops, SERVING_GOLDEN, "serving_sweep",
            out["serving"]["solo"] if "serving" in out else None),
        "malleable": lambda: phase_malleable(torch, rt, ops),
        "malleable_sweep": lambda: phase_malleable_sweep(torch, rt, ops),
        "oracle": lambda: phase_oracle(rt, ops, np),
        "window": lambda: phase_window(
            rt, ops, out["golden"][2] if "golden" in out else None),
        "multicluster": lambda: phase_multicluster(rt, ops, np),
        "replay": lambda: phase_replay(rt, ops, np),
        "flash": lambda: phase_flash(torch, np),
        "lm_golden": lambda: phase_lm_golden(torch, np),
        "serve": lambda: phase_serve(torch, np),
        "linattn": lambda: phase_linattn(torch, np),
        "rwkv_golden": lambda: phase_lm_golden(torch, np, "rwkv6-7b",
                                               "rwkv_golden"),
        "rwkv_serve": lambda: phase_rwkv_serve(torch, np)}
    out = {}
    for name in PHASES:
        if only is None or name in only:
            out[name] = phases[name]()
    if only is not None:
        emit("total", t_all, only=only)
        return 0

    max_err, timing = out["kernel"]
    fused_err, modes, walk = out["fused"]
    alloc, dag = out["alloc"], out["dag"]
    rel, svc, mal = out["reliability"], out["serving"], out["malleable"]
    stream_sweeps = out["reliability_sweep"] + out["serving_sweep"]
    mal_sweeps = out["malleable_sweep"]
    oracle, wf_batch = out["oracle"], out["workflow_batch"]
    windows = [out["window"], out["multicluster"], out["replay"]]
    launches = (out["golden"][0] + out["archive"][0] + alloc["launches"]
                + dag["launches"] + out["workflow"][0] + rel["launches"]
                + svc["launches"] + mal["launches"] + oracle["launches"]
                + sum(c["launches"] for c in windows))
    walk_launches = (out["golden"][1] + out["archive"][1]
                     + alloc["walk_launches"] + dag["walk_launches"]
                     + rel["walk_launches"] + svc["walk_launches"]
                     + mal["walk_launches"] + oracle["walk_launches"]
                     + sum(c["walk_launches"] for c in windows))
    cand = modes["backfill_cand"]
    batch_err, batch_timing, generic_batch = out["batched"]
    batch_runs = [*out["sweep"], out["ensemble"], out["alloc_sweep"],
                  *out["dag_sweep"], *stream_sweeps, *mal_sweeps,
                  out["multicluster"]]
    batch_launches = sum(c["batch_launches"] for c in batch_runs)
    batch_selections = sum(c["batch_selections"] for c in batch_runs)
    walk_batch_launches = sum(c["walk_batch_launches"] for c in batch_runs)
    flash_err, flash = out["flash"]
    flash_launches = out["serve"]
    lin_err, lin = out["linattn"]
    lin_launches = out["rwkv_serve"]

    # queue_select's numbers are those of the main path's widest fused
    # mode, the backfill candidate pick; every mode, the generic op and the
    # walk follow under their own keys
    print(json.dumps({"kernels": [{
        "name": "queue_select",
        "route": "cuda",
        "source": "src/repro_torch/kernels/queue_select/csrc/queue_select.cu",
        "replaces": "src/repro/kernels/queue_select/kernel.py:23",
        "launches": launches,
        "max_abs_err": max(max_err, fused_err, batch_err),
        "ms": cand["ms"],
        "plain_ms": cand["plain_ms"],
        "bound_ms": cand["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": f"N={timing['n']}, fused backfill_cand mode, host clock "
                 "around the call (launch, wait, answer in host memory)",
        "device_us_per_call": cand["device_us_per_call"],
        "machine_mode": {
            "launches": alloc["launches"],
            "walk_launches": alloc["walk_launches"],
            "batch_launches": out["alloc_sweep"]["batch_launches"],
            "batch_selections": out["alloc_sweep"]["batch_selections"],
            "walk_batch_launches": out["alloc_sweep"]["walk_batch_launches"]},
        "dag_mode": {
            "launches": dag["launches"],
            "walk_launches": dag["walk_launches"],
            "workflow_launches": out["workflow"][0],
            "batch_launches": sum(c["batch_launches"]
                                  for c in out["dag_sweep"]),
            "batch_selections": sum(c["batch_selections"]
                                    for c in out["dag_sweep"]),
            "walk_batch_launches": sum(c["walk_batch_launches"]
                                       for c in out["dag_sweep"])},
        "stream_mode": {
            "reliability_launches": rel["launches"],
            "reliability_walk_launches": rel["walk_launches"],
            "serving_launches": svc["launches"],
            "serving_walk_launches": svc["walk_launches"],
            "batch_launches": sum(c["batch_launches"]
                                  for c in stream_sweeps),
            "batch_selections": sum(c["batch_selections"]
                                    for c in stream_sweeps),
            "walk_batch_launches": sum(c["walk_batch_launches"]
                                       for c in stream_sweeps)},
        "oracle_mode": {"launches": oracle["launches"],
                        "walk_launches": oracle["walk_launches"]},
        "window_mode": {phase: out[phase] for phase in (
            "window", "multicluster", "replay")},
        "malleable_mode": {
            "launches": mal["launches"],
            "walk_launches": mal["walk_launches"],
            "batch_launches": sum(c["batch_launches"] for c in mal_sweeps),
            "batch_selections": sum(c["batch_selections"]
                                    for c in mal_sweeps),
            "walk_batch_launches": sum(c["walk_batch_launches"]
                                       for c in mal_sweeps)},
        "modes": modes,
        "generic": {"ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
                    "bound_ms": timing["bound_ms"], "bound_by": "bytes",
                    "library_ms": timing["library_ms"],
                    "device_us_per_call": timing["device_us_per_call"],
                    "shape": f"N={timing['n']}, bool mask, CUDA events"},
        "walk": {"name": "shadow_walk", "launches": walk_launches,
                 "max_abs_err": walk["max_abs_err"], "ms": walk["ms"],
                 "plain_ms": walk["plain_ms"], "bound_ms": walk["bound_ms"],
                 "bound_by": "bytes", "library_ms": None,
                 "device_us_per_call": walk["device_us_per_call"],
                 "steps": walk["steps"]},
        "batched": {
            "entries": "queue_select_fused_batch, queue_select_walk_batch",
            "launches": batch_launches,
            "member_selections": batch_selections,
            "walk_launches": walk_batch_launches,
            "max_abs_err": batch_err,
            "shape": f"J={BATCH_J} a member, every member backfill_cand "
                     f"(select) or a {WALK_STEPS}-release walk, host clock "
                     "around the call",
            "by_members": {B: {w: {k: t[w][k] for k in (
                "ms", "plain_ms", "bound_ms", "members_per_launch",
                "device_us_per_call")} | {"bound_by": "bytes",
                                           "library_ms": None}
                for w in ("select", "walk")}
                for B, t in batch_timing.items()}},
        "batched_generic": {
            "name": "queue_select_batch",
            "entry": "queue_select_batch (the batched pool engine's "
                     "selections: one upload of the members, one launch of "
                     "one cluster a member)",
            "launches": wf_batch["launches"],
            "member_selections": wf_batch["selections"],
            "max_abs_err": batch_err,
            "shape": "B members x T tasks, bool mask, every member "
                     "requested, host clock around the call",
            "by_shape": {shape: {k: t[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "members_per_launch", "device_us_per_call",
                "device_ops_per_call")}
                for shape, t in generic_batch.items()}},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_sm90.cu",
        "f32_source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
        "launches": flash_launches,
        "max_abs_err": flash_err,
        "ms": flash["kernel_ms"],
        "f32_ms": flash["f32_ms"],
        "hd80_ms": flash["hd80_ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "shape": flash["shape"],
        "flops": flash["flops"],
        "bytes": flash["bytes"],
    }, {
        "name": "linattn_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/linattn_scan/csrc/"
                  "linattn_scan_sm90.cu",
        "f32_source": "src/repro_torch/kernels/linattn_scan/csrc/"
                      "linattn_scan.cu",
        "replaces": "src/repro/kernels/linattn_scan/kernel.py:23",
        "launches": lin_launches,
        "max_abs_err": lin_err,
        "ms": lin["kernel_ms"],
        "cuda_core_ms": lin["cuda_core_ms"],
        "cuda_core_bound_ms": lin["cuda_core_bound_ms"],
        "plain_ms": lin["plain_ms"],
        "bound_ms": lin["bound_ms"],
        "bound_by": lin["bound_by"],
        "library_ms": lin["library_ms"],
        "library_call": lin["library_call"],
        "shape": lin["shape"],
        "flops": lin["flops"],
        "bytes": lin["bytes"],
    }]}), flush=True)
    emit("total", t_all)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
