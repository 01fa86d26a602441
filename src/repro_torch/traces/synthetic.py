"""Synthetic workload generators with the statistical shape of the paper's
traces (GWA-DAS2, SDSC-SP2).

The PyTorch port's own copy of ``repro.traces.synthetic`` (the port imports
nothing of the JAX package); both give the same arrays for the same seed.

Published characteristics we match (Iosup et al. 2008; PWA SDSC-SP2 page):

- DAS-2: ~1.1M jobs over ~1.5 years on 400 processors across 5 clusters;
  bursty arrivals, short median runtimes (tens of seconds to minutes),
  power-of-two node requests dominate, heavy-tailed runtime distribution.
- SDSC-SP2: 73,496 jobs, 128-node SP2, longer runtimes (median ~8 min,
  heavy tail to 18h), requested walltimes overestimate actuals ~2-5x.

Everything is deterministic given ``seed``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_trace(
    n_jobs: int,
    *,
    seed: int = 0,
    mean_interarrival: float = 30.0,
    runtime_lognorm=(5.0, 1.6),
    max_runtime: int = 36_000,
    node_pow2_max: int = 6,
    large_frac: float = 0.08,
    total_nodes: int = 128,
    estimate_factor=(1.0, 5.0),
    burstiness: float = 0.5,
) -> Dict[str, np.ndarray]:
    """Generic bursty heavy-tailed trace generator.

    - arrivals: Markov-modulated Poisson-ish (bursts switch the rate x8),
    - runtimes: lognormal clipped to ``max_runtime``,
    - nodes: power-of-two biased, with a ``large_frac`` tail of big jobs,
    - estimates: runtime x Uniform(estimate_factor), as in SP2-style logs.
    """
    rng = np.random.default_rng(seed)
    burst = rng.random(n_jobs) < burstiness
    gaps = rng.exponential(mean_interarrival, n_jobs)
    gaps = np.where(burst, gaps / 8.0, gaps)
    submit = np.cumsum(gaps).astype(np.int64)

    mu, sigma = runtime_lognorm
    runtime = np.clip(rng.lognormal(mu, sigma, n_jobs), 1, max_runtime).astype(np.int64)

    pows = rng.integers(0, node_pow2_max + 1, n_jobs)
    nodes = (2 ** pows).astype(np.int64)
    big = rng.random(n_jobs) < large_frac
    nodes = np.where(big, rng.integers(total_nodes // 4, total_nodes + 1, n_jobs), nodes)
    nodes = np.clip(nodes, 1, total_nodes)

    lo, hi = estimate_factor
    estimate = np.clip((runtime * rng.uniform(lo, hi, n_jobs)).astype(np.int64),
                       runtime, None)
    return {
        "submit": submit, "runtime": runtime, "nodes": nodes, "estimate": estimate,
    }


def das2_like(n_jobs: int = 10_000, *, seed: int = 0) -> Dict[str, np.ndarray]:
    """DAS-2-shaped trace (400-processor grid, short bursty jobs)."""
    return synthetic_trace(
        n_jobs, seed=seed, mean_interarrival=45.0, runtime_lognorm=(4.2, 1.8),
        max_runtime=15 * 3600, node_pow2_max=5, large_frac=0.04,
        total_nodes=400, estimate_factor=(1.5, 8.0), burstiness=0.6,
    )


def sdsc_sp2_like(n_jobs: int = 10_000, *, seed: int = 1) -> Dict[str, np.ndarray]:
    """SDSC-SP2-shaped trace (128-node SP2, longer heavy-tailed jobs)."""
    return synthetic_trace(
        n_jobs, seed=seed, mean_interarrival=430.0, runtime_lognorm=(6.2, 1.9),
        max_runtime=18 * 3600, node_pow2_max=7, large_frac=0.06,
        total_nodes=128, estimate_factor=(1.2, 5.0), burstiness=0.4,
    )


DAS2_TOTAL_NODES = 400
SDSC_SP2_TOTAL_NODES = 128
