"""The vlm and encdec families on the card, held to the same code on the
CPU.

f32, TF32 off, reduced qwen2-vl-72b and seamless-m4t-medium with the
seeded numpy weights of the golden file (attention at its true fan-in,
seamless's LayerNorms drawn live) and seeded numpy requests split as the
input specs split them.  One prefill on the kernel path (the f32 flash
kernel: one launch a vlm layer, three an encoder-decoder layer, its
cross-attention not square) and two decode steps: logits within 1e-4, the
caches within a max-norm relative error of 1e-4.  They need a CUDA device
and skip without one; the file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_vlm_encdec_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.serve import _prefill_cache, request_inputs
from repro_torch.models.api import get_model
from repro_torch.tree import tree_items

TOL = 1e-4
ARCHS = {"qwen2-vl-72b": dict(fan_in=True),
         "seamless-m4t-medium": dict(live_seed=1, fan_in=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_on_card_match_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True)
    model = get_model(cfg)
    tree = numpy_lm_params(cfg, 0, **ARCHS[arch])
    inputs = request_inputs(cfg, 2, 75, 0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 2))
    start = inputs["tokens"].shape[1] + (inputs["patches"].shape[1]
                                         if "patches" in inputs else 0)
    out = {}
    for dev in ("cpu", "cuda"):
        params = lm_params_from_numpy(tree, dev)
        before = flash_attention.launches
        last, pre = model.prefill(params, {k: torch.from_numpy(v).to(dev)
                                           for k, v in inputs.items()})
        if dev == "cuda":
            want = (cfg.enc_layers + 2 * cfg.n_layers
                    if cfg.family == "encdec" else cfg.n_layers)
            assert flash_attention.launches - before == want
        cache = _prefill_cache(model, pre, 2, start + 2, dev)
        logits = [last]
        for i, tok in enumerate(toks):
            lg, cache = model.decode_step(
                params, torch.from_numpy(tok).to(dev), start + i, cache)
            logits.append(lg)
        out[dev] = ([t.cpu() for t in logits],
                    {k: t.cpu() for k, t in tree_items(cache)})
    for got, want in zip(*(out[d][0] for d in ("cuda", "cpu"))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL)
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        assert got.shape == want.shape, k
        assert float((got - want).abs().max()) <= TOL * float(
            want.abs().max()), k
