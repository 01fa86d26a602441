"""The JAX package's serving answers for the PyTorch port's on-card check.

``chip_smoke.py`` runs the port's LM on the card, where JAX is not
installed, and holds it to ``tests/data/torch_lm_golden.json``, a list of
two entries: for reduced llama3.2-3b and reduced rwkv6-7b in f32 with the
seeded numpy weights of ``repro_torch.convert.numpy_lm_params`` (for
rwkv6-7b with its zero-init leaves drawn live, from ``live_seed``), the
JAX package's ``prefill`` last-position logits and the tokens its
``serve_batch`` generates.  The rwkv prompt, 75 tokens, is longer than two
of the kernel's 32-step tiles and ends in a ragged one.  These tests
recompute the entries with JAX and fail when the file is stale, and hold
the port on the CPU to them.

Regenerate the file with ``PYTHONPATH=src python tests/test_torch_lm_golden.py``.
"""

import contextlib
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.launch.serve as jax_serve
from repro.configs.base import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.models.api import ModelAPI
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
from repro_torch.launch.serve import serve_batch

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_lm_golden.json")
RUNS = [{"arch": "llama3.2-3b", "reduced": True, "seed": 0, "batch": 2,
         "prompt_len": 24, "gen": 8},
        {"arch": "rwkv6-7b", "reduced": True, "seed": 0, "live_seed": 1,
         "batch": 2, "prompt_len": 75, "gen": 8}]
# f32 logits: see test_torch_lm.py for why two f32 implementations of
# the dense model may differ by up to 5e-4 (rwkv's differ by under 1e-5,
# test_torch_rwkv.py)
TOL = 5e-4


@contextlib.contextmanager
def _jax_serve_with(params):
    """JAX's ``serve_batch`` with ``params`` in place of its own init."""

    @dataclasses.dataclass(frozen=True)
    class Fixed(ModelAPI):
        def init(self, key):
            return params

    real = jax_serve.get_model
    jax_serve.get_model = lambda cfg: Fixed(
        **{f.name: getattr(real(cfg), f.name)
           for f in dataclasses.fields(ModelAPI)})
    try:
        yield
    finally:
        jax_serve.get_model = real


def golden_entry(run: dict) -> dict:
    cfg = jax_get_config(run["arch"]).reduced()
    params = jax.tree.map(jnp.asarray, numpy_lm_params(
        get_config(run["arch"]).reduced(), run["seed"],
        live_seed=run.get("live_seed")))
    prompts = np.random.default_rng(run["seed"]).integers(
        1, cfg.vocab - 1, (run["batch"], run["prompt_len"])).astype(np.int32)
    last, _ = jax_lm.prefill(params, {"tokens": jnp.asarray(prompts)}, cfg)
    with _jax_serve_with(params):
        seqs, _ = jax_serve.serve_batch(cfg, run["batch"], run["prompt_len"],
                                        run["gen"], seed=run["seed"])
    seqs = np.asarray(seqs)
    assert (seqs[:, :run["prompt_len"]] == prompts).all()
    return {**run, "prompts": prompts.tolist(),
            "last_logits": np.asarray(last, np.float32).tolist(),
            "tokens": seqs.tolist()}


def _load() -> list:
    with open(GOLDEN) as fh:
        return json.load(fh)


def test_golden_entry_is_current():
    entries = _load()
    assert len(entries) == len(RUNS)
    for run, got in zip(RUNS, entries):
        want = golden_entry(run)
        assert {k: got[k] for k in run} == run
        assert got["prompts"] == want["prompts"]
        assert got["tokens"] == want["tokens"]
        np.testing.assert_allclose(got["last_logits"], want["last_logits"],
                                   rtol=1e-6, atol=1e-7)


def test_port_on_cpu_matches_golden():
    """What chip_smoke.py checks on the card, here on the CPU."""
    from repro_torch.models.lm import prefill
    for g in _load():
        cfg = dataclasses.replace(get_config(g["arch"]).reduced(),
                                  use_pallas=True)
        params = lm_params_from_numpy(numpy_lm_params(
            cfg, g["seed"], live_seed=g.get("live_seed")), "cpu")
        seqs, _ = serve_batch(cfg, g["batch"], g["prompt_len"], g["gen"],
                              seed=g["seed"], params=params, device="cpu")
        assert seqs.tolist() == g["tokens"], g["arch"]
        last, _ = prefill(params, {"tokens": torch.tensor(g["prompts"])}, cfg)
        np.testing.assert_allclose(last.numpy(), g["last_logits"], atol=TOL,
                                   rtol=TOL, err_msg=g["arch"])


if __name__ == "__main__":
    with open(GOLDEN, "w") as fh:
        json.dump([golden_entry(run) for run in RUNS], fh)
        fh.write("\n")
    print(f"wrote {GOLDEN}")
