#!/usr/bin/env python3
"""Split a linattn_scan kernel's time among its candidate causes.

    python3 scripts/linattn_split.py            # the CUDA-core kernel
    python3 scripts/linattn_split.py --sm90     # the tensor-core kernel
    python3 scripts/linattn_split.py --control  # lower-precision sm90 builds

Needs one Hopper card and nvcc.  Writes variants of
``src/repro_torch/kernels/linattn_scan/csrc/linattn_scan.cu`` (or, with
``--sm90``, of ``linattn_scan_sm90.cu``) into
``build/linattn_split/`` (gitignored; the variants are timing probes whose
results are wrong, and are never part of the port), builds each with the
port's nvcc flags, and times each at the rwkv6-7b serve shape (B 4, H 64,
S 2,048, K 64, bf16 r/k/v, f32 logw, the model's [B, S, H, K] layout) with
CUDA events, alternating the variants so that clock drift falls on all.
Prints one JSON line per variant (median ms, and ms minus the unchanged
kernel's) and the ptxas lines of every build, then the card's name and
power limit.

Variants of the CUDA-core kernel, each one text change of the source:
  base        unchanged
  no_exp      the pair phase's exp2f removed (its FMAs and loads stay)
  no_pairs    the pair phase skipped (its exp2f, FMAs, loads, shuffles)
  no_rdec_s   the r_dec . S product of y skipped
  no_update   the state update skipped
  one_per_sm  dynamic shared memory raised to 120 KB: one block an SM

and of the sm90 kernel:
  base        unchanged
  no_diag     the diagonal sub-blocks' loop skipped (CUDA cores)
  diag_no_exp the diagonal loop's exp2 removed (its FMAs and loads stay)
  no_inter    the three cross-sub-chunk products and their operands skipped
  no_rdec_s   the (r exp2(Eex)) S_prev product skipped
  no_lo       the state update's lo product skipped (hi only)
  one_per_sm  dynamic shared memory raised to 120 KB: one CTA an SM

With ``--control`` it builds lower-precision variants of the sm90 kernel
instead, puts each in turn in place of the port's build (``ops._sm90_lib``)
and runs the checks of ``chip_smoke.py`` that hold its precision: phase
10's serve-shape call against the token scan (y within 5e-2 of its largest
entry, the state within 1e-4) and phase 12a's full-width bf16 rwkv6-7b
prefill against the plain path (``BF16_LOGIT_TOL``, ``BF16_STATE_TOL``).
It also holds the call to ``ref.py``'s statement of the kernel's
arithmetic (``sm90_statement_errs``, the measure of
``tests/test_torch_kernels_cuda.py``'s statement test).  One JSON line per
variant gives each reading and whether phases 10 and 12a pass it:
  base        unchanged
  no_lo       the state update's kw rounded to bf16 once (2^-9 a term)
  state_bf16  the carried state rounded to bf16 at every chunk's end
  kw_3bit     kw truncated to 3 mantissa bits, no lo product (2^-3 a term)
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src/repro_torch/kernels/linattn_scan/csrc"
OUT = ROOT / "build" / "linattn_split"
ROUNDS, CALLS = 5, 20
# the mangled name of each kernel's serve instantiation (bf16 r/k/v, f32
# logw, K = 64)
SERVE_FN = {False: "13__nv_bfloat16fLi64E", True: "ILi64EfE"}

SM90_VARIANTS = {
    "base": [],
    "no_diag": [("for (int m = 0; m < 15; ++m) {\n        const bool on_a",
                 "for (int m = 0; m < 0; ++m) {\n        const bool on_a")],
    "diag_no_exp": [("exp2_fast(xx - ee)", "(xx - ee)")],
    "no_inter": [("if (warp > j) {", "if (false) {"),
                 ("wgmma_n16(inter[j], af[1 + j][kk],",
                  "if (false) wgmma_n16(inter[j], af[1 + j][kk],")],
    "no_rdec_s": [("wgmma_n64(yacc, af[0][kk],",
                   "if (false) wgmma_n64(yacc, af[0][kk],")],
    "no_lo": [("wgmma_n64(sacc[m], lo[m][kk], bv, 1);", "")],
    "one_per_sm": [("constexpr int smem = Lay<K>::kSmem;",
                    "constexpr int smem = Lay<K>::kSmem > 120 * 1024 ? "
                    "Lay<K>::kSmem : 120 * 1024;")],
}

VARIANTS = {
    "base": [],
    "no_exp": [("exp2f(at(xx, i) - at(ee, j))", "(at(xx, i) - at(ee, j))")],
    "no_pairs": [("if (tid < (kTri * kSplit + 31) / 32 * 32) {",
                  "if (false) {")],
    "no_rdec_s": [("for (int c = 0; c < K; ++c) {", "for (int c = 0; c < 0; ++c) {")],
    "no_update": [("for (int o = tid; o < (K / 4) * (K / 4); o += kThreads) {",
                   "for (int o = tid; o < 0; o += kThreads) {")],
    "one_per_sm": [("const int smem = smem_floats<K>() * (int)sizeof(float);",
                    "const int smem = max(smem_floats<K>() * (int)sizeof(float),"
                    " 120 * 1024);")],
}

# lower-precision builds of the sm90 kernel, for the checks' limits
_STAGE_FREE = ("    fence_async_smem();\n"
               "    __syncthreads();   // stage s is free")
CONTROLS = {
    "base": [],
    "no_lo": SM90_VARIANTS["no_lo"],
    "state_bf16": [(_STAGE_FREE,
                    "    for (int m = 0; m < K / 64; ++m)\n"
                    "      for (int e = 0; e < 32; ++e)\n"
                    "        sacc[m][e] = __bfloat162float("
                    "__float2bfloat16(sacc[m][e]));\n" + _STAGE_FREE)],
    "kw_3bit": SM90_VARIANTS["no_lo"] + [
        ("hi[m][kk][x] = h2;", "hi[m][kk][x] = h2 & 0xfff0fff0u;")],
}


def make_variant(name: str, text: str, variants: dict,
                 prefix: str) -> pathlib.Path:
    for old, new in variants[name]:
        n = text.count(old)
        if n < 1:
            raise SystemExit(f"{name}: {old!r} not in the source")
        text = text.replace(old, new)
    path = OUT / f"{prefix}_{name}.cu"
    path.write_text(text)
    return path


def serve_ptxas(log: str, fn: str) -> list:
    """ptxas's lines for the instantiation the serve shape runs (bf16 r/k/v,
    f32 logw, K = 64)."""
    lines, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            keep = fn in ln or (keep and "Function properties" in ln)
        if keep and ("registers" in ln or "spill" in ln):
            lines.append(ln.strip())
    return lines


def build(text: str, variants: dict, prefix: str, fn: str) -> dict:
    """Write and build every variant, one nvcc each, all at once:
    ``{name: (path of the library, ptxas lines of the serve instantiation)}``."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in variants:
        src = make_variant(name, text, variants, prefix)
        so = OUT / f"{prefix}_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        out[name] = (so, serve_ptxas(log, fn))
    return out


def serve_inputs(torch):
    """r, k, v, logw, u at the serve shape from seed 0, as [B, H, S, K]
    views of the model's [B, S, H, K] layout."""
    B, H, S, K = 4, 64, 2048, 64
    gen = torch.Generator("cuda").manual_seed(0)
    r, k, v = (0.5 * torch.randn((B, S, H, K), device="cuda", generator=gen,
                                 dtype=torch.bfloat16) for _ in range(3))
    lw = -torch.exp(0.5 * torch.randn((B, S, H, K), device="cuda",
                                      generator=gen))
    u = 0.5 * torch.randn((H, K), device="cuda", generator=gen)
    r, k, v, lw = (x.transpose(1, 2) for x in (r, k, v, lw))
    return r, k, v, lw, u


def run_controls(torch, np, builds: dict) -> None:
    """Phase 10's serve-shape check and phase 12a's full-width check, with
    each build in place of the port's sm90 kernel."""
    import dataclasses
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.linattn_scan import ops, ref
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    r, k, v, lw, u = serve_inputs(torch)
    wy, wst = ref.linattn_reference(r, k, v, lw, u)
    stated = ref.linattn_sm90_reference(r, k, v, lw, u)
    base, _, params, toks = cs.rwkv_full_width(torch, np)
    cfg16 = dataclasses.replace(base, use_pallas=True)
    want, wc = lm.prefill(params, {"tokens": toks},
                          dataclasses.replace(cfg16, use_pallas=False))
    want, wstate = want.float().cpu().numpy(), wc["wkv"]
    y_tol, s_tol = cs.LINATTN_TOL["bfloat16"], cs.LINATTN_TOL["float32"]
    for name, (so, _) in builds.items():
        lib = ops._bind_sm90(so)
        ops._sm90_lib = lambda lib=lib: lib
        ops.reset_launches()
        y, st = ops.linattn(r, k, v, lw, u, return_state=True)
        ey = float((y.float() - wy.float()).abs().max() / wy.float().abs().max())
        es = float((st - wst).abs().max() / wst.abs().max())
        ty, trms, ts = ref.sm90_statement_errs((y, st), stated)
        err, state_err, argmax_equal, _ = cs.bf16_prefill_errs(
            np, params, cfg16, toks, want, wstate)
        if ops.linattn.launches_by_route["sm90_bf16"] != 1 + base.n_layers:
            raise SystemExit(f"{name}: the sm90 route was not taken")
        print(json.dumps({
            "kernel": "linattn_sm90", "control": name,
            "call_y_rel_err": ey, "call_state_rel_err": es,
            "call_passes": ey < y_tol and es < s_tol,
            "statement_y_excess": ty, "statement_y_rms": trms,
            "statement_state_rel_err": ts,
            "prefill_logit_rel_err": err, "prefill_state_rel_err": state_err,
            "prefill_argmax_equal": argmax_equal,
            "prefill_passes": (err < cs.BF16_LOGIT_TOL
                               and state_err < cs.BF16_STATE_TOL)}),
              flush=True)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    control = "--control" in args
    sm90 = control or "--sm90" in args
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("linattn_split: no CUDA device", file=sys.stderr)
        return 1
    prefix = "linattn_sm90" if sm90 else "linattn"
    variants = CONTROLS if control else SM90_VARIANTS if sm90 else VARIANTS
    text = (CSRC / f"{prefix.replace('linattn', 'linattn_scan')}.cu").read_text()
    builds = build(text, variants, prefix, SERVE_FN[sm90])
    if control:
        run_controls(torch, np, builds)
    else:
        time_variants(torch, builds, sm90, prefix)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    return 0


def time_variants(torch, builds: dict, sm90: bool, prefix: str) -> None:
    """Each build's median time at the serve shape, CUDA events, alternated."""
    libs, ptxas = {}, {}
    for name, (so, lines) in builds.items():
        ptxas[name] = lines
        lib = ctypes.CDLL(str(so))
        fn = lib.linattn_scan_sm90_launch if sm90 else lib.linattn_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * (5 if sm90 else 6)
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn

    r, k, v, lw, u = serve_inputs(torch)
    B, H, S, K = r.shape
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), device="cuda")
    strides = (ctypes.c_longlong * 15)(
        *(s for x in (r, k, v, lw, y) for s in x.stride()[:3]))
    stream = torch.cuda.current_stream().cuda_stream

    dtypes = (0,) if sm90 else (1, 0)   # [dtype of r/k/v,] dtype of logw

    def call(fn):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                 u.data_ptr(), y.data_ptr(), state.data_ptr(), *dtypes,
                 B, H, S, K, ctypes.addressof(strides), stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")

    times = {name: [] for name in libs}
    for lib in libs.values():
        for _ in range(3):
            call(lib)
    torch.cuda.synchronize()
    for _ in range(ROUNDS):
        for name, lib in libs.items():
            for _ in range(CALLS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call(lib)
                b.record()
                times[name].append((a, b))
    torch.cuda.synchronize()
    ms = {n: statistics.median(a.elapsed_time(b) for a, b in ev)
          for n, ev in times.items()}
    for name in libs:
        print(json.dumps({"kernel": prefix, "variant": name, "ms": ms[name],
                          "minus_base_ms": ms[name] - ms["base"],
                          "calls": ROUNDS * CALLS, "ptxas": ptxas[name]}))


if __name__ == "__main__":
    sys.exit(main())
