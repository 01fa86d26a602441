"""The JAX package's serving answers for the PyTorch port's on-card check.

``chip_smoke.py`` runs the port's LM on the card, where JAX is not
installed, and holds it to ``tests/data/torch_lm_golden.json``, a list of
one entry a run of ``RUNS``: for a reduced config in f32 with the seeded
numpy weights of ``repro_torch.convert.numpy_lm_params`` (with
``live_seed``, the leaves that the initializer leaves at zero or one drawn
live: rwkv6-7b's, zamba2-2.7b's Mamba2 leaves, llama4-scout's QK norms,
seamless-m4t-medium's LayerNorms; with ``fan_in``, the attention at its
true fan-in), the JAX package's ``prefill`` last-position logits and the
tokens it generates.  The tokens are those of its ``serve_batch``, but for
moe, vlm and encdec.  For moe they are those of its ``prefill`` followed
by its ``decode_step`` (``_torch_lm.jax_prefill_decode``), the port's
request path, since the JAX ``serve_batch`` prefills through decode steps,
which route with no capacity (``tests/test_torch_moe.py::
test_jax_serve_batch_parts_from_its_prefill_and_decode``).  The JAX
``serve_batch`` never draws a vlm's patches or an encoder-decoder's
source, so for vlm they are those of its ``prefill`` with the patches
followed by its ``decode_step`` at the positions after them, and for
encdec those of its ``decode_step`` over the prompt with the cross cache
made from its ``encode`` (``_torch_lm.jax_encdec_decode``); an encdec
entry's ``last_logits`` are its ``forward``'s at the last target
position.  These entries carry their ``patches`` or ``src_embeds`` beside
the ``prompts`` (the text tokens), and the card replays them.  A moe entry
records its least router margin (``min_router_margin``, over the prefill
and decode steps), and it must be at least ``MIN_MARGIN``, so that the
card is not asked to reproduce a near-tie.

The rwkv prompt, 75 tokens, is longer than two of the kernel's 32-step
tiles and ends in a ragged one; mixtral's, 80 tokens, is longer than its
64-token window, so the ring and the window both bind; zamba2's, 40
tokens, is two 16-step chunks and a ragged one; qwen2-vl's 40 positions
are 10 patches and 30 tokens; seamless's 75 are 37 source frames and 38
target tokens, so the cross-attention is ragged and not square.  These tests recompute the
entries with JAX and fail when the file is stale, and hold the port on the
CPU to them.

Regenerate the file with ``PYTHONPATH=src python tests/test_torch_lm_golden.py``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_lm as tl
import repro.launch.serve as jax_serve
from repro.configs.base import get_config as jax_get_config
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, numpy_lm_params
from repro_torch.launch.serve import serve_batch

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_lm_golden.json")
RUNS = [{"arch": "llama3.2-3b", "reduced": True, "seed": 0, "batch": 2,
         "prompt_len": 24, "gen": 8},
        {"arch": "rwkv6-7b", "reduced": True, "seed": 0, "live_seed": 1,
         "batch": 2, "prompt_len": 75, "gen": 8},
        {"arch": "mixtral-8x7b", "reduced": True, "seed": 0, "batch": 2,
         "prompt_len": 80, "gen": 8},
        {"arch": "llama4-scout-17b-a16e", "reduced": True, "seed": 0,
         "live_seed": 1, "batch": 2, "prompt_len": 24, "gen": 8},
        {"arch": "zamba2-2.7b", "reduced": True, "seed": 0, "live_seed": 1,
         "batch": 2, "prompt_len": 40, "gen": 8},
        {"arch": "qwen2-vl-72b", "reduced": True, "seed": 0, "fan_in": True,
         "batch": 2, "prompt_len": 40, "gen": 8},
        {"arch": "seamless-m4t-medium", "reduced": True, "seed": 0,
         "live_seed": 1, "fan_in": True, "batch": 2, "prompt_len": 75,
         "gen": 8}]
MODALITY = ("patches", "src_embeds")
# f32 logits: see test_torch_lm.py for why two f32 implementations of
# the dense model may differ by up to 5e-4 (rwkv's differ by under 1e-5,
# test_torch_rwkv.py)
TOL = 5e-4
MIN_MARGIN = 1e-5


def weights(run: dict) -> dict:
    """The entry's seeded numpy weights."""
    return numpy_lm_params(get_config(run["arch"]).reduced(), run["seed"],
                           live_seed=run.get("live_seed"),
                           fan_in=run.get("fan_in", False))


def golden_entry(run: dict) -> dict:
    cfg = jax_get_config(run["arch"]).reduced()
    params = jax.tree.map(jnp.asarray, weights(run))
    inputs = tl.jax_inputs(cfg, run["batch"], run["prompt_len"], run["seed"])
    prompts = inputs["tokens"]
    extra = {k: inputs[k].tolist() for k in MODALITY if k in inputs}
    if cfg.family == "encdec":
        last = jax_encdec.forward(params, jax.tree.map(jnp.asarray, inputs),
                                  cfg)[:, -1]
        seqs, _ = tl.jax_encdec_decode(cfg, params, prompts, run["gen"],
                                       tl.jax_cross_cache(
                                           cfg, params, inputs["src_embeds"]))
    else:
        last, _ = jax_lm.prefill(params, jax.tree.map(jnp.asarray, inputs),
                                 cfg)
    if cfg.family == "vlm":
        seqs = tl.jax_prefill_decode(cfg, params, prompts, run["gen"],
                                     inputs.get("patches"))
    elif cfg.family == "moe":
        seqs = tl.jax_prefill_decode(cfg, params, prompts, run["gen"])
        extra["min_router_margin"] = tl.least_router_margin(
            get_config(run["arch"]).reduced(), jax.tree.map(np.asarray, params),
            run["batch"], run["prompt_len"], run["gen"], run["seed"])
    elif cfg.family != "encdec":
        with tl.jax_serve_with(params):
            seqs, _ = jax_serve.serve_batch(cfg, run["batch"],
                                            run["prompt_len"], run["gen"],
                                            seed=run["seed"])
    seqs = np.asarray(seqs)
    assert (seqs[:, :prompts.shape[1]] == prompts).all()
    return {**run, "prompts": prompts.tolist(),
            "last_logits": np.asarray(last, np.float32).tolist(),
            "tokens": seqs.tolist(), **extra}


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
        for k in MODALITY:
            assert got.get(k) == want.get(k), k
        np.testing.assert_allclose(got["last_logits"], want["last_logits"],
                                   rtol=1e-6, atol=1e-7)
        if "min_router_margin" in want:
            np.testing.assert_allclose(got["min_router_margin"],
                                       want["min_router_margin"], rtol=1e-3)


def test_moe_entries_keep_clear_of_router_ties():
    moe = [g for g in _load() if get_config(g["arch"]).family == "moe"]
    assert len(moe) == 2
    for g in moe:
        assert g["min_router_margin"] >= MIN_MARGIN, g["arch"]


def golden_inputs(g: dict) -> dict:
    """An entry's request as numpy arrays: its prompts, and its patches or
    source frames."""
    return {"tokens": np.asarray(g["prompts"], np.int32),
            **{k: np.asarray(g[k], np.float32) for k in MODALITY if k in g}}


def test_modality_entries_hold_their_inputs():
    """The vlm and encdec entries carry their patches and source frames,
    split as the input specs split a request, and the port's
    ``request_inputs`` draws the same from the seed."""
    from repro_torch.launch.serve import request_inputs
    got = {g["arch"]: g for g in _load()}
    assert np.shape(got["qwen2-vl-72b"]["patches"]) == (2, 10, 128)
    assert np.shape(got["qwen2-vl-72b"]["prompts"]) == (2, 30)
    assert np.shape(got["seamless-m4t-medium"]["src_embeds"]) == (2, 37, 128)
    assert np.shape(got["seamless-m4t-medium"]["prompts"]) == (2, 38)
    for g in got.values():
        drawn = request_inputs(get_config(g["arch"]).reduced(), g["batch"],
                               g["prompt_len"], g["seed"])
        want = golden_inputs(g)
        assert sorted(drawn) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(drawn[k], want[k])


def test_port_on_cpu_matches_golden():
    """What chip_smoke.py checks on the card, here on the CPU."""
    from repro_torch.models.api import get_model
    for g in _load():
        cfg = dataclasses.replace(get_config(g["arch"]).reduced(),
                                  use_pallas=True)
        params = lm_params_from_numpy(weights(g), "cpu")
        inputs = golden_inputs(g)
        seqs, _ = serve_batch(cfg, g["batch"], g["prompt_len"], g["gen"],
                              seed=g["seed"], params=params, device="cpu",
                              inputs=inputs)
        assert seqs.tolist() == g["tokens"], g["arch"]
        last, _ = get_model(cfg).prefill(
            params, {k: torch.from_numpy(v) for k, v in inputs.items()})
        np.testing.assert_allclose(last.numpy(), g["last_logits"], atol=TOL,
                                   rtol=TOL, err_msg=g["arch"])


if __name__ == "__main__":
    with open(GOLDEN, "w") as fh:
        json.dump([golden_entry(run) for run in RUNS], fh)
        fh.write("\n")
    print(f"wrote {GOLDEN}")
