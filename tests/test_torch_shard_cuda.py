"""The sharded layout on the card: ``chip_smoke.py`` phase shard's checks
at reduced size.  Two ranks share the card over gloo
(``repro_torch.launch.spawn_world``; NCCL refuses two ranks on one card),
over ``("data", "model")`` meshes 2 x 1 and 1 x 2:

- reduced llama3.2-3b's and rwkv6-7b's f32 loss and every gathered
  gradient against the one-card ``mesh=None`` run on the same card: loss
  within rtol 1e-5, gradients within atol 1e-5 + rtol 1e-4;
- on 1 x 2 under ``SERVE_RULES``, a prefill and greedy decode steps with
  ``use_pallas`` set: the flash kernel launched on each rank's local
  heads, the logits within 1e-4 of the one-card run's (the kernel's f32
  sums against another split of the heads' products), the tokens equal.

They need a CUDA device and skip without one; the file imports neither
JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_shard_cuda.py
"""

import numpy as np
import pytest
import torch

import _torch_shard_worker as w
from repro_torch.launch import make_local_mesh, spawn_world

ARCH = "llama3.2-3b"
GRAD_ARCHS = ("llama3.2-3b", "rwkv6-7b")


def card_rank(_, shape) -> dict:
    """One rank: the mesh results, and rank 0's one-card results."""
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.sharding.rules import SERVE_RULES
    mesh = make_local_mesh(("data", "model"), "cuda", shape=shape)
    out = {"grads": {a: w.loss_and_grads(a, mesh, device="cuda")
                     for a in GRAD_ARCHS}}
    if shape == (1, 2):
        fops.reset_launches()
        out["serve"] = w.serve_run(ARCH, SERVE_RULES, mesh, device="cuda")
        out["flash_launches"] = fops.flash_attention.launches
    if dist.get_rank() == 0:
        out["one_grads"] = {a: w.loss_and_grads(a, None, device="cuda")
                            for a in GRAD_ARCHS}
        out["one_serve"] = w.serve_run(ARCH, None, None, device="cuda")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=("2x1", "1x2"))
def test_sharded_layout_on_card_matches_one_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = spawn_world(card_rank, 2, args=(shape,), device_type="cuda",
                        timeout=600, group_timeout=120)
    r0 = ranks[0]
    for arch in GRAD_ARCHS:
        loss, grads = r0["grads"][arch]
        want_loss, want = r0["one_grads"][arch]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=arch)
        for k in want:
            np.testing.assert_allclose(grads[k], want[k], atol=1e-5,
                                       rtol=1e-4, err_msg=f"{arch} {k}")
    if shape == (1, 2):
        assert all(r["flash_launches"] > 0 for r in ranks)
        logits, tokens = r0["serve"]
        want_logits, want_tokens = r0["one_serve"]
        assert tokens == want_tokens
        for a, b in zip(logits, want_logits):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
