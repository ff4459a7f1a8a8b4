"""Shared helpers of the port's parity tests (not a test module).

Inputs are made from a seed with numpy and handed to both packages; the JAX
package runs on the CPU as its own tests run it.
"""

from __future__ import annotations

import numpy as np


def rel_max_err(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-30))


def corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def jax_init_params(seed: int = 3):
    """A fresh JAX SOT-2048 encoder init as a numpy param tree."""
    import jax

    from sot_tpu.configs import get_experiment
    from sot_tpu.training.trainer import build_modules, init_state

    state = init_state(build_modules(get_experiment("SOT-2048")), jax.random.key(seed))
    return jax.tree.map(np.asarray, state.params)


def tone_batch(batch: int, n_samples: int = 4095, seed: int = 0) -> np.ndarray:
    """Two-partial tones at 16 kHz, peak ~0.9 (the JAX CQT tests' inputs)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    f0 = rng.uniform(60, 600, size=(batch, 1))
    x = np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(2 * np.pi * 2 * f0 * t)
    return (x * 0.9).astype(np.float32)
