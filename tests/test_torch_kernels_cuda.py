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
