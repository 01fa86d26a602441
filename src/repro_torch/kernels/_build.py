"""Build the port's CUDA kernels from the sources in the checkout.

Each ``.cu`` file under ``repro_torch/kernels/<name>/csrc/`` has a plain C
interface and compiles on its own, with ``nvcc`` for ``sm_90a``, into a
shared library that ``ctypes`` loads.  The library lands in
``build/torch_kernels/`` at the root of the checkout, named after the hash
of its source and flags, so an edited source rebuilds and an unchanged one
is reused.  Nothing builds at import time: the first launch on a CUDA
tensor calls :func:`build`.  A missing ``nvcc`` is an error.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every kernel source of the port, relative to KERNELS_DIR
SOURCES = ("queue_select/csrc/queue_select.cu",
           "flash_attention/csrc/flash_attention.cu",
           "flash_attention/csrc/flash_attention_sm90.cu",
           "linattn_scan/csrc/linattn_scan.cu",
           "linattn_scan/csrc/linattn_scan_sm90.cu")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        nvcc = candidate if os.path.exists(candidate) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from source "
            "with the CUDA toolkit")
    return nvcc


def library_path(source: str) -> pathlib.Path:
    src = KERNELS_DIR / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _start(source: str):
    """Start one nvcc process into a temporary file, or return None when
    the library for this source is already built."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(KERNELS_DIR / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(source: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return log


def build_all(sources=SOURCES) -> dict:
    """Build every source at once (one nvcc each, all started together);
    returns ``{source: nvcc output}`` ("" where the build was reused)."""
    started = {s: _start(s) for s in sources}
    logs, errors = {}, []
    for s, p in started.items():   # wait for every nvcc, even after a failure
        try:
            logs[s] = _finish(s, p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def build(source: str) -> pathlib.Path:
    """The shared library for ``source``, built first if needed."""
    _finish(source, _start(source))
    return library_path(source)
