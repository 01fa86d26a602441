"""The port's ``queue_select`` against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; it must equal
``repro.kernels.queue_select.ref.queue_select_reference`` and the JAX op's
compiled default lowering bit for bit.  The CUDA kernel itself is held to
the plain version on the card (``test_torch_kernels_cuda.py`` and
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.queue_select.ops import queue_select as jax_queue_select
from repro.kernels.queue_select.ref import queue_select_reference
from repro_torch.kernels.queue_select import ops
from repro_torch.kernels.queue_select.ref import BIG

MASKS = {"bool": torch.bool, "int32": torch.int32}


def _both(scores: np.ndarray, feas: np.ndarray, mask: str):
    got = ops.queue_select(torch.from_numpy(scores),
                           torch.from_numpy(feas).to(MASKS[mask]))
    assert got.dtype == torch.int32 and got.shape == (2,)
    return got.numpy()


def _reference(scores: np.ndarray, feas: np.ndarray):
    ref = np.asarray(queue_select_reference(
        jnp.asarray(scores), jnp.asarray(feas.astype(np.int32))))
    compiled = np.asarray(jax_queue_select(
        jnp.asarray(scores), jnp.asarray(feas.astype(np.int32))))
    np.testing.assert_array_equal(ref, compiled)
    return ref


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("N", [7, 100, 1024, 5000, 65536])
@pytest.mark.parametrize("feas_rate", [0.0, 0.05, 0.5, 1.0])
def test_grid_matches_jax(N, feas_rate, mask):
    rng = np.random.default_rng(N * 7 + int(feas_rate * 100))
    # negative and positive scores with many ties (N >> distinct values)
    scores = rng.integers(-5000, 5000, N).astype(np.int32)
    feas = rng.random(N) < feas_rate
    np.testing.assert_array_equal(_both(scores, feas, mask),
                                  _reference(scores, feas))


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_negative_scores(mask):
    scores = np.array([5, -3, -2**31, 7, -2**31 + 1], np.int32)
    feas = np.array([True, True, False, True, True])
    got = _both(scores, feas, mask)
    np.testing.assert_array_equal(got, [4, -2**31 + 1])
    np.testing.assert_array_equal(got, _reference(scores, feas))


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_feasible_big_returns_its_index(mask):
    scores = np.full(50, BIG, np.int32)
    feas = np.zeros(50, bool)
    feas[[31, 17]] = True
    got = _both(scores, feas, mask)
    np.testing.assert_array_equal(got, [17, BIG])
    np.testing.assert_array_equal(got, _reference(scores, feas))


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_ties_pick_lowest_index(mask):
    scores = np.zeros(256, np.int32)
    feas = np.zeros(256, bool)
    feas[[40, 7, 200]] = True
    got = _both(scores, feas, mask)
    assert got[0] == 7
    np.testing.assert_array_equal(got, _reference(scores, feas))


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_empty_mask(mask):
    scores = np.arange(300, dtype=np.int32)
    feas = np.zeros(300, bool)
    got = _both(scores, feas, mask)
    np.testing.assert_array_equal(got, [-1, BIG])
    np.testing.assert_array_equal(got, _reference(scores, feas))


@pytest.mark.parametrize("feasible", [True, False])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_single_entry(mask, feasible):
    scores = np.array([-9], np.int32)
    feas = np.array([feasible])
    got = _both(scores, feas, mask)
    np.testing.assert_array_equal(got, [0, -9] if feasible else [-1, BIG])
    np.testing.assert_array_equal(got, _reference(scores, feas))


def test_cpu_path_does_not_count_launches():
    before = ops.queue_select.launches
    ops.queue_select(torch.zeros(8, dtype=torch.int32),
                     torch.ones(8, dtype=torch.bool))
    assert ops.queue_select.launches == before


@pytest.mark.parametrize("scores,feasible,err", [
    (torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool),
     TypeError),
    (torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.float32),
     TypeError),
    (torch.zeros((2, 2), dtype=torch.int32), torch.ones((2, 2), dtype=torch.bool),
     ValueError),
    (torch.zeros(4, dtype=torch.int32), torch.ones(5, dtype=torch.bool),
     ValueError),
    (torch.zeros(0, dtype=torch.int32), torch.ones(0, dtype=torch.bool),
     ValueError),
    (torch.zeros(4, dtype=torch.int32),
     torch.ones(4, dtype=torch.bool, device="meta"), ValueError),
    (torch.zeros(4, dtype=torch.int32, device="meta"),
     torch.ones(4, dtype=torch.bool, device="meta"), ValueError),
], ids=["int64-scores", "float-mask", "2-d", "length-mismatch", "empty",
        "device-mismatch", "meta-device"])
def test_wrapper_rejects(scores, feasible, err):
    with pytest.raises(err):
        ops.queue_select(scores, feasible)
