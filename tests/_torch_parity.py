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


def reference_layout(seed: int, n_bins: int = 285, n_modes: int = 20,
                     channels=(40, 30, 30, 10, 3), kernel_size: int = 15,
                     prefix: str = "") -> dict:
    """A state dict in the reference (Lightning) encoder's layout, the one
    ``sot_tpu/models/import_torch.py``'s docstring gives, with weights drawn
    from ``seed`` as U(+-1/sqrt(fan_in)) (numpy float32). Written out key by
    key, apart from both importers' own maps."""
    rng = np.random.default_rng(seed)
    c = channels
    features = n_bins * c[4]
    shapes = {"layernorm.weight": ((1, n_bins), None), "layernorm.bias": ((1, n_bins), None)}
    convs = (("conv1.0", 1, c[0], kernel_size), ("prefilt_list.0.0", c[0], c[0], kernel_size),
             ("conv2.0", c[0], c[1], 1), ("conv3.0", c[1], c[2], 1),
             ("conv4.0", c[2], c[3], 1), ("conv4.3", c[3], c[4], 1))
    for name, cin, cout, k in convs:
        shapes[f"{name}.weight"] = ((cout, cin, k), cin * k)
        shapes[f"{name}.bias"] = ((cout,), cin * k)
    n_taps = features + n_bins - 1
    shapes["linear.frequency.0.weight"] = ((1, 1, n_taps), n_taps)
    shapes["linear.weights.0.weight"] = ((n_modes, features), features)
    shapes["linear.weights.0.bias"] = ((n_modes,), features)
    sd = {}
    for name, (shape, fan_in) in shapes.items():
        if fan_in is None:  # the LayerNorm's affine, near its (1, 0) init
            base = 1.0 if name.endswith("weight") else 0.0
            v = base + 0.1 * rng.standard_normal(shape)
        else:
            bound = 1.0 / np.sqrt(fan_in)
            v = rng.uniform(-bound, bound, shape)
        sd[prefix + name] = v.astype(np.float32)
    return sd
