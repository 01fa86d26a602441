"""One reduced training step on the card, held to the same step on the
CPU, and repeated on the card bit for bit.

For reduced llama3.2-3b (attention at its true fan-in) and reduced
rwkv6-7b (live leaves), f32, one ``Trainer`` step on a 4 x 32 synthetic
batch: the loss within rtol 1e-5 and every gradient within atol 1e-5 +
rtol 1e-4 of the CPU's (the products sum in another order on the card;
TF32 stays off).  Two runs of the step on the card give the same
gradients bit for bit: the failure-recovery replay relies on it (the
embedding's backward pass sums repeated tokens in a fixed order).  They
need a CUDA device and skip without one; the file imports neither JAX nor
the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.optim import AdamWConfig, CompressionState, adamw_init
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_items

RUNS = {"llama3.2-3b": {"live_seed": None, "fan_in": True},
        "rwkv6-7b": {"live_seed": 3, "fan_in": False}}


def _step(arch, device):
    """(loss, {leaf: gradient}) of one trainer step on ``device``."""
    cfg = get_config(arch).reduced()
    tree = numpy_lm_params(cfg, 0, **RUNS[arch])
    tr = Trainer(cfg, AdamWConfig(lr=1e-3), TrainerConfig(
        steps=1, log_every=10**9), SyntheticTokens(cfg.vocab, 4, 32, seed=1),
        log=lambda *_: None, device=device)

    def init_state():
        p = lm_params_from_numpy(tree, device)
        return p, adamw_init(p), CompressionState(
            residual=torch.zeros((), device=device))

    tr._init_state = init_state
    res = tr.run()
    return res["final_loss"], {k: g.cpu().numpy()
                               for k, g in tree_items(tr._grads)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(RUNS))
def test_one_step_on_card_matches_cpu_and_repeats(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    loss, grads = _step(arch, "cuda")
    want_loss, want = _step(arch, "cpu")
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    again_loss, again = _step(arch, "cuda")
    assert again_loss == loss
    for k in grads:
        np.testing.assert_array_equal(again[k], grads[k], err_msg=k)
