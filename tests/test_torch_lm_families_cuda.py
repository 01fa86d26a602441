"""The moe and hybrid families on the card, held to the same code on the
CPU.

f32, TF32 off, seeded numpy weights and inputs (the leaves that ``init``
leaves at zero or one drawn live).  ``apply_moe`` at reduced mixtral-8x7b
and llama4-scout-17b-a16e over S = 24 (slots dropped) and 3,000 (4
dispatch groups): y within atol = rtol = 2e-5, the experts picked and the
slots kept equal.  ``_ssd_chunked`` with a ragged last chunk: y and the
final state within 2e-5.  One reduced prefill of each config on the
kernel path (the f32 flash kernel) against the CPU's: logits within 5e-4,
the flash kernel launched on every attention layer.  They need a CUDA
device and skip without one; the file imports neither JAX nor the JAX
package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_lm_families_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import lm, moe, ssm
from repro_torch.tree import tree_map

MOE = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
ARCHS = MOE + ["zamba2-2.7b"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _tree(arch):
    cfg = get_config(arch).reduced()
    return cfg, numpy_lm_params(cfg, 0, live_seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [24, 3000])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_on_card_matches_cpu(arch, S):
    _card()
    cfg, tree = _tree(arch)
    p = tree_map(lambda a: torch.from_numpy(np.asarray(a[0])),
                 tree["blocks"]["moe"])
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal((2, S, cfg.d_model),
                                             dtype=np.float32) + 1.0)
    out = {}
    for dev in ("cpu", "cuda"):
        with moe.recording() as rec:
            y, aux = moe.apply_moe(tree_map(lambda t: t.to(dev), p),
                                   x.to(dev), cfg)
        out[dev] = (y.cpu().numpy(), float(aux), rec[0]["gate_idx"].cpu(),
                    rec[0]["kept"].cpu())
    (y, aux, idx, kept), (wy, waux, widx, wkept) = out["cuda"], out["cpu"]
    assert torch.equal(idx, widx) and torch.equal(kept, wkept)
    np.testing.assert_allclose(y, wy, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(aux, waux, rtol=1e-6)


@pytest.mark.cuda
def test_ssd_chunked_on_card_matches_cpu():
    _card()
    rng = np.random.default_rng(0)
    B, S, H, P, N = 2, 300, 8, 32, 16
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))  # noqa: E731
    x, Bm, Cm = f(B, S, H, P), f(B, S, N) * 0.5, f(B, S, N) * 0.5
    dt = torch.nn.functional.softplus(f(B, S, H) - 3.0)
    A = -torch.exp(f(H) * 0.5)
    want, wst = ssm._ssd_chunked(x, dt, A, Bm, Cm, 128)
    got, st = ssm._ssd_chunked(*(t.cuda() for t in (x, dt, A, Bm, Cm)), 128)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(st.cpu().numpy(), wst.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_on_card_matches_cpu(arch):
    _card()
    cfg, tree = _tree(arch)
    cfg = dataclasses.replace(cfg, use_pallas=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab - 1, (2, 80)))
    want, _ = lm.prefill(lm_params_from_numpy(tree, "cpu"), {"tokens": toks},
                         cfg)
    before = flash_attention.launches
    got, cache = lm.prefill(lm_params_from_numpy(tree, "cuda"),
                            {"tokens": toks.cuda()}, cfg)
    layers = (cfg.n_layers // cfg.attn_every if cfg.attn_every
              else cfg.n_layers)
    assert flash_attention.launches == before + layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=5e-4,
                               rtol=5e-4)
