"""Generate the port's paper-table golden from the JAX package (not a test
module).

For each committed seed-42 checkpoint of a paper family (``CKPTS``) it
restores the checkpoint on the CPU with the gates of
``tests/_torch_golden_train.py``, builds the family's preset, generates the
preset's dataset (``sot_tpu.data.dataset_from_config``: 4000 clips, a
400-clip test split) and evaluates the test split as
``sot_tpu/eval_paper.py``'s ``evaluate_run`` does (``evaluate`` with
``make_eval_step``, batches of the preset's 64). It evaluates the same
weights again on the port's own dataset (``sot_tpu_torch.data``, rendered on
the CPU): the same draws, but the two synth paths round the phase
differently (f32 blocks here, one float64 prefix there), so the clips differ
by up to ~1% of their peak and a rounding-sensitive metric (the MSS
distance of log magnitudes) moves by a few 1e-3. Writes

    sot_tpu_torch/golden/paper_seed42.npz

with, for each family ``<EXP>``:
  * ``<EXP>/params/<flax path>``: the encoder's Flax leaves, and ``<EXP>/step``
  * ``<EXP>/paper/<column>``: ``rename_metrics(evaluate(...))``, the row of
    the paper table (LSD, MSE, MSS, OD, RPA, RCA)
  * ``<EXP>/eval/<metric>``: ``evaluate``'s own metrics, loss terms included
  * ``<EXP>/eval_port_data/<metric>``: the same on the port's test split
and, shared by every family (all presets draw the same dataset),
``data/test_frequency`` [400, 1], the test split's true f0, so that a reader
can check that its own split holds the same clips, and
``data/test_x_max_abs_diff``, the largest difference between the two
packages' test clips; ``gates``: the gates used.

    JAX_PLATFORMS=cpu python -m tests._torch_golden_paper
"""

from __future__ import annotations

import os

import numpy as np

from tests._torch_golden import flatten
from tests._torch_golden_train import GATES, _set_gates

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "sot_tpu_torch", "golden", "paper_seed42.npz")
_CK = os.path.join(ROOT, "results", "checkpoints")
CKPTS = {
    "SOT-2048": os.path.join(_CK, "best", "SOT-2048-42"),
    **{exp: os.path.join(_CK, "ref", f"{exp}-42")
       for exp in ("SOT-512", "SOT-512-LogF", "SOT-NoCut", "SOT-2048-SS", "MSS-Lin",
                   "MSS-LogLin")},
}


def generate() -> str:
    _set_gates()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")

    from sot_tpu import data as data_lib
    from sot_tpu.configs import get_experiment
    from sot_tpu.eval_paper import rename_metrics
    from sot_tpu.training import checkpoint
    from sot_tpu.training.trainer import build_modules, evaluate, init_state, make_eval_step
    from sot_tpu_torch import data as port_data
    from sot_tpu_torch.configs import get_experiment as port_experiment

    payload = {"gates": np.array(" ".join(f"{k}={v}" for k, v in sorted(GATES.items())))}
    splits, data_key = None, None
    for exp, path in CKPTS.items():
        cfg = get_experiment(exp)
        key = (cfg.data_seed, cfg.dataset_size, cfg.n_samples, cfg.freq_gen_min,
               cfg.freq_gen_max, cfg.amplitude_min, cfg.amplitude_max, cfg.n_sinusoids)
        if key != data_key:
            splits, data_key = data_lib.dataset_from_config(cfg), key
            port_test = port_data.dataset_from_config(port_experiment(exp), device="cpu")["test"]
            if "data/test_frequency" in payload:
                raise ValueError(f"{exp}: a preset with another dataset; the golden holds one")
            payload["data/test_frequency"] = np.asarray(splits["test"].frequency, np.float32)
            assert np.array_equal(port_test.frequency, splits["test"].frequency)
            payload["data/test_x_max_abs_diff"] = np.float64(
                np.abs(port_test.x - splits["test"].x).max())
        mod = build_modules(cfg)
        state, step = checkpoint.restore(path, init_state(mod, jax.random.key(0)))
        metrics = evaluate(mod, make_eval_step(mod), state.params, splits["test"],
                           cfg.batch_size)
        on_port = evaluate(mod, make_eval_step(mod), state.params, port_test, cfg.batch_size)
        paper = rename_metrics(metrics)
        params = jax.tree.map(np.asarray, state.params["params"])
        payload.update({f"{exp}/{k}": v for k, v in flatten(params).items()})
        payload[f"{exp}/step"] = np.asarray(step, np.int64)
        payload.update({f"{exp}/eval/{k}": np.float64(v) for k, v in metrics.items()})
        payload.update({f"{exp}/paper/{k}": np.float64(v) for k, v in paper.items()})
        payload.update({f"{exp}/eval_port_data/{k}": np.float64(v) for k, v in on_port.items()})
        print(exp, f"step {step}:", ", ".join(f"{k} {v:.6f}" for k, v in paper.items()),
              flush=True)
    np.savez(GOLDEN, **payload)
    return GOLDEN


if __name__ == "__main__":
    print("wrote", generate())
