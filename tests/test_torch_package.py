"""Package rules of the PyTorch port: it stands alone beside the JAX package
and builds nothing when imported."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

FORBIDDEN = [re.compile(p, re.MULTILINE) for p in (
    r"^\s*(import|from)\s+jax\b",
    r"^\s*from\s+repro(\.|\s)",
    r"^\s*import\s+repro(\.|\s|,|$)",
)]


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    return out.stdout


def test_import_loads_no_jax_and_no_repro():
    out = _run(
        "import sys, repro_torch, repro_torch.convert, repro_torch.traces\n"
        "import repro_torch.kernels._build, repro_torch.kernels.queue_select.ops\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.configs\n"
        "import repro_torch.kernels.linattn_scan.ops, repro_torch.models.rwkv\n"
        "import repro_torch.kernels._tma\n"
        "import repro_torch.models.api, repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n")
    assert out.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PORT)) for p in PORT.rglob("*.py")))
def test_source_imports_neither_jax_nor_repro(path):
    text = (PORT / path).read_text()
    for pat in FORBIDDEN:
        assert not pat.search(text), (path, pat.pattern)


def test_import_and_cpu_run_build_no_kernel():
    """Importing every module and running on the CPU neither starts nvcc
    nor loads a kernel library: neither the engine nor the LM's serve path
    with ``use_pallas`` set, dense or rwkv."""
    out = _run(
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a subprocess was started')\n"
        "subprocess.Popen = refuse\n"
        "import repro_torch as rt\n"
        "from repro_torch.kernels.queue_select import ops\n"
        "scn = rt.Scenario(trace=rt.SyntheticTrace(n_jobs=30), "
        "total_nodes=64, policy='backfill')\n"
        "rt.run(scn, device='cpu')\n"
        "import dataclasses\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.kernels.flash_attention import ops as fops\n"
        "from repro_torch.launch.serve import serve_batch\n"
        "cfg = dataclasses.replace(get_config('llama3.2-3b').reduced(), "
        "use_pallas=True)\n"
        "serve_batch(cfg, 2, 8, 3, device='cpu')\n"
        "from repro_torch.kernels.linattn_scan import ops as lops\n"
        "cfg = dataclasses.replace(get_config('rwkv6-7b').reduced(), "
        "use_pallas=True)\n"
        "serve_batch(cfg, 2, 40, 3, device='cpu')\n"
        "print(ops._lib.cache_info().currsize, ops.queue_select.launches,\n"
        "      fops._lib.cache_info().currsize, fops.flash_attention.launches,\n"
        "      fops._sm90_lib.cache_info().currsize,\n"
        "      lops._lib.cache_info().currsize,\n"
        "      lops._sm90_lib.cache_info().currsize, lops.linattn.launches)\n")
    assert out.split() == ["0"] * 8
