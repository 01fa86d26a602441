"""The JAX trainer's per-step numbers for the port's training phase on the
card.

``chip_smoke.py``'s ``train`` phase trains reduced models on the card,
where JAX is not installed, and holds each step to
``tests/data/torch_train_golden.json``: for each run, the config, weights,
data and trainer settings, the tolerances, and per step the JAX
``Trainer``'s loss, ce, grad norm and learning rate, its ``_init_state``
given the seeded numpy weights of ``numpy_lm_params`` (dense attention at
its true fan-in, rwkv's zero-init leaves drawn live).  Two runs of 8 steps
at batch 4 x 32, lr 1e-3 (warmup 2, cosine to step 8), a checkpoint every
4 steps: reduced llama3.2-3b with ``accum=2``, reduced rwkv6-7b with int8
compression.  The file also holds each step's token windows and the numpy
version that drew them: the card replays the windows, since numpy's zipf
sampler (``SyntheticTokens``) gives another stream from the same key under
another numpy.

Tolerances (stated per run in the file): losses and ce within rtol 5e-4
(``chip_smoke.py``'s ``LM_TOL``; the CPU's agree within 3e-6); grad norms
within 5e-4, or 1e-2 on the compressed run (int8 rounding is
discontinuous, see ``test_torch_train.py``; the CPU's part by up to
2.1e-3 there); the lr within 1e-6 (f32 rounding of one formula).

These tests recompute the runs with JAX and fail when the file is stale
(rtol 1e-5: XLA's CPU code may round differently on another host), and
hold the port's CPU trainer to the file.  Regenerate it with
``PYTHONPATH=src python tests/test_torch_train_golden.py``.
"""

import json
import os

import numpy as np

import _torch_train as tt
from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro.data import pipeline as jax_pipeline
from repro_torch.convert import numpy_lm_params

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_train_golden.json")
OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 8}
DATA = {"batch": 4, "seq": 32, "seed": 1}
RUNS = [
    {"name": "llama3.2-3b/accum2", "arch": "llama3.2-3b",
     "weights": {"seed": 0, "live_seed": None, "fan_in": True},
     "trainer": {"steps": 8, "ckpt_every": 4, "accum": 2},
     "tol": {"loss": 5e-4, "ce": 5e-4, "grad_norm": 5e-4, "lr": 1e-6}},
    {"name": "rwkv6-7b/compress", "arch": "rwkv6-7b",
     "weights": {"seed": 0, "live_seed": tt.LIVE_SEED, "fan_in": False},
     "trainer": {"steps": 8, "ckpt_every": 4, "compress_grads": True},
     "tol": {"loss": 5e-4, "ce": 5e-4, "grad_norm": 1e-2, "lr": 1e-6}},
]


def _weights(run):
    _, cfg = tt.configs(run["arch"])
    return numpy_lm_params(cfg, **run["weights"])


def _data(run):
    return (DATA["batch"], DATA["seq"], DATA["seed"])


def _windows(run) -> list:
    """Each step's token windows ``[batch, seq + 1]`` from the JAX
    pipeline: the card replays them, since numpy's zipf sampler, and so
    the stream a Philox key gives, differs between numpy versions."""
    ds = jax_pipeline.SyntheticTokens(tt.configs(run["arch"])[0].vocab,
                                      DATA["batch"], DATA["seq"],
                                      seed=DATA["seed"])
    out = []
    for step in range(run["trainer"]["steps"]):
        b = ds.batch_at(step)
        out.append(np.concatenate([b["tokens"], b["labels"][:, -1:]],
                                  axis=1).tolist())
    return out


def golden_entry(run: dict) -> dict:
    steps, res = tt.run_jax(run["arch"], _weights(run), OPT, run["trainer"],
                            _data(run))
    assert res["restarts"] == 0
    return {**run, "opt": OPT, "data": DATA, "numpy": np.__version__,
            "tokens": _windows(run), "steps": steps}


def _load() -> list:
    with open(GOLDEN) as fh:
        return json.load(fh)


def test_golden_file_is_current():
    entries = _load()
    assert [e["name"] for e in entries] == [r["name"] for r in RUNS]
    for run, got in zip(RUNS, entries):
        want = golden_entry(run)
        same = [k for k in want if k not in ("steps", "numpy")]
        assert {k: got[k] for k in same} == {k: want[k] for k in same}
        assert [s["step"] for s in got["steps"]] == list(range(8))
        for k in tt.KEYS:
            np.testing.assert_allclose([s[k] for s in got["steps"]],
                                       [s[k] for s in want["steps"]],
                                       rtol=1e-5, err_msg=f"{run['name']} {k}")


def test_port_on_cpu_meets_golden():
    """What chip_smoke.py checks on the card, here on the CPU."""
    for g in _load():
        steps, _, _ = tt.run_port(g["arch"], _weights(g), g["opt"],
                                  g["trainer"], _data(g))
        for k in tt.KEYS:
            np.testing.assert_allclose(
                [s[k] for s in steps], [s[k] for s in g["steps"]],
                rtol=g["tol"][k], err_msg=f"{g['name']} {k}")


if __name__ == "__main__":
    with open(GOLDEN, "w") as fh:
        json.dump([golden_entry(run) for run in RUNS], fh, indent=1)
        fh.write("\n")
    print(f"wrote {GOLDEN}")
