"""The JAX package's serving answers for the PyTorch port's on-card check.

``chip_smoke.py`` runs the port's LM on the card, where JAX is not
installed, and holds it to ``tests/data/torch_lm_golden.json``: for reduced
llama3.2-3b in f32 with the seeded numpy weights of
``repro_torch.convert.numpy_lm_params``, the JAX package's ``prefill``
last-position logits and the tokens its ``serve_batch`` generates.  These
tests recompute the entry with JAX and fail when the file is stale, and
hold the port on the CPU to it.

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
RUN = {"arch": "llama3.2-3b", "reduced": True, "seed": 0, "batch": 2,
       "prompt_len": 24, "gen": 8}
# f32 logits: see test_torch_lm.py for why two f32 implementations of
# this model may differ by up to 5e-4
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


def golden_entry() -> dict:
    cfg = jax_get_config(RUN["arch"]).reduced()
    params = jax.tree.map(jnp.asarray, numpy_lm_params(
        get_config(RUN["arch"]).reduced(), RUN["seed"]))
    prompts = np.random.default_rng(RUN["seed"]).integers(
        1, cfg.vocab - 1, (RUN["batch"], RUN["prompt_len"])).astype(np.int32)
    last, _ = jax_lm.prefill(params, {"tokens": jnp.asarray(prompts)}, cfg)
    with _jax_serve_with(params):
        seqs, _ = jax_serve.serve_batch(cfg, RUN["batch"], RUN["prompt_len"],
                                        RUN["gen"], seed=RUN["seed"])
    seqs = np.asarray(seqs)
    assert (seqs[:, :RUN["prompt_len"]] == prompts).all()
    return {**RUN, "prompts": prompts.tolist(),
            "last_logits": np.asarray(last, np.float32).tolist(),
            "tokens": seqs.tolist()}


def _load() -> dict:
    with open(GOLDEN) as fh:
        return json.load(fh)


def test_golden_entry_is_current():
    got, want = _load(), golden_entry()
    assert {k: got[k] for k in RUN} == RUN
    assert got["prompts"] == want["prompts"]
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["last_logits"], want["last_logits"],
                               rtol=1e-6, atol=1e-7)


def test_port_on_cpu_matches_golden():
    """What chip_smoke.py checks on the card, here on the CPU."""
    g = _load()
    cfg = dataclasses.replace(get_config(g["arch"]).reduced(),
                              use_pallas=True)
    params = lm_params_from_numpy(numpy_lm_params(cfg, g["seed"]), "cpu")
    seqs, _ = serve_batch(cfg, g["batch"], g["prompt_len"], g["gen"],
                          seed=g["seed"], params=params, device="cpu")
    assert seqs.tolist() == g["tokens"]
    from repro_torch.models.lm import prefill
    last, _ = prefill(params, {"tokens": torch.tensor(g["prompts"])}, cfg)
    np.testing.assert_allclose(last.numpy(), g["last_logits"], atol=TOL,
                               rtol=TOL)


if __name__ == "__main__":
    with open(GOLDEN, "w") as fh:
        json.dump(golden_entry(), fh)
        fh.write("\n")
    print(f"wrote {GOLDEN}")
