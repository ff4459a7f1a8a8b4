"""Generate the port's golden file from the JAX package (not a test module).

Restores the committed SOT-2048 seed-42 checkpoint
(``results/checkpoints/best/SOT-2048-42``) on the CPU, draws 64 clips from
``sot_tpu.data.generate_sinusoid_dataset``, runs ``sot_tpu`` ``predict`` on
them in float32, and writes

    sot_tpu_torch/golden/sot2048_seed42_predict.npz

holding the parameters (``params/<flax path>``), the peak-normalised clips
``x`` and their true ``f0``, the JAX outputs ``pitch_hz``, ``pitch_unit`` and
``weights``, and the checkpoint ``step``. The port's tests and
``chip_smoke.py`` hold the port against it.

    JAX_PLATFORMS=cpu python -m tests._torch_golden
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results", "checkpoints", "best", "SOT-2048-42")
GOLDEN = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot2048_seed42_predict.npz")
DATA_SEED = 7
N_CLIPS = 64


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    return jax


def restore_params():
    """(flax param tree as numpy, step) of the committed checkpoint."""
    jax = _jax_cpu()
    from sot_tpu.configs import get_experiment
    from sot_tpu.training import checkpoint
    from sot_tpu.training.trainer import build_modules, init_state

    mod = build_modules(get_experiment("SOT-2048"))
    state, step = checkpoint.restore(CKPT, init_state(mod, jax.random.key(0)))
    return jax.tree.map(np.asarray, state.params), step


def flatten(tree, prefix: str = "params") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def generate() -> str:
    jax = _jax_cpu()
    import jax.numpy as jnp

    from sot_tpu import data as data_lib
    from sot_tpu.configs import get_experiment
    from sot_tpu.training.trainer import build_modules, predict

    params, step = restore_params()
    cfg = get_experiment("SOT-2048")
    signals, f0, _ = data_lib.generate_sinusoid_dataset(
        seed=DATA_SEED, size=N_CLIPS, n_samples=cfg.n_samples, render_batch=N_CLIPS)
    x = data_lib.peak_normalize(signals).astype(np.float32)
    out = predict(build_modules(cfg), jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    payload = {
        **flatten(params["params"]),
        "x": x,
        "f0": f0.astype(np.float32),
        "pitch_hz": np.asarray(out["pitch_hz"], np.float32),
        "pitch_unit": np.asarray(out["pitch_unit"], np.float32),
        "weights": np.asarray(out["weights"], np.float32),
        "step": np.asarray(step, np.int64),
    }
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez(GOLDEN, **payload)
    return GOLDEN


if __name__ == "__main__":
    print("wrote", generate())
