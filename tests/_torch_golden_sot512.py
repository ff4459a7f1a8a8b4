"""Generate the port's SOT-512 golden file from the JAX package (not a test
module).

Restores the committed SOT-512 seed-42 checkpoint
(``results/checkpoints/best/SOT-512-42``) on the CPU and takes the clips of
``sot_tpu_torch/golden/sot2048_seed42_predict.npz`` (``tests/_torch_golden.py``).
The JAX package runs with the shipped kernel gates in interpret mode, except
the two that only change precision, as ``tests/_torch_golden_train.py`` sets
them: at SOT-512's 257 bins ``SOT_TPU_W2_MERGE_SMALL=hybrid`` sends the SOT
loss to the merge forward and the banded-plane backward. Writes

    sot_tpu_torch/golden/sot512_seed42_trainstep.npz

with
  * ``params/<flax path>`` and the checkpoint ``step``
  * ``x`` [16, 4096]: the predict golden's first 16 clips; ``loss_total``,
    ``loss_mss``, ``loss_w1d`` (the weighted terms of ``compute_loss`` in
    eval mode) and each term's gradient per parameter leaf
    (``grad_<term>/<flax path>``)
  * for the first 8 clips (128 rows x 258 lanes), the SOT kernels on real
    rows: the clipped CDFs of JAX's spectra summed in float64
    (``sot_alpha``, ``sot_beta``), the grid (``sot_gaug``), the merge
    route's W_2^2 rows (``sot_w``) and the banded-plane backward's beta
    cotangent for the mean's row weight (``sot_db``, ``_pallas_bwd`` with
    the constant target of training)
  * ``eval/<metric>``: ``evaluate`` (the six default metrics and the loss
    terms, one batch) on all 64 predict-golden clips with their ``f0``; its
    batches are peak-normalised again, as the port's ``evaluate`` does
  * ``gates``: the gates used

    JAX_PLATFORMS=cpu python -m tests._torch_golden_sot512
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from tests._torch_golden import GOLDEN as PREDICT_GOLDEN
from tests._torch_golden import flatten
from tests._torch_golden_train import GATES, N_CLIPS, N_SOT_CLIPS, TERMS, _set_gates

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results", "checkpoints", "best", "SOT-512-42")
GOLDEN = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot512_seed42_trainstep.npz")
EXPERIMENT = "SOT-512"


def restore_params():
    """(flax param tree as numpy, step) of the committed SOT-512 checkpoint."""
    import jax

    from sot_tpu.configs import get_experiment
    from sot_tpu.training import checkpoint
    from sot_tpu.training.trainer import build_modules, init_state

    mod = build_modules(get_experiment(EXPERIMENT))
    state, step = checkpoint.restore(CKPT, init_state(mod, jax.random.key(0)))
    return jax.tree.map(np.asarray, state.params), step


def sot_rows(mod, params, x: np.ndarray) -> Dict[str, np.ndarray]:
    """The hybrid route's kernels on real rows: the clipped augmented CDFs
    [rows, 258] of the batch's SOT loss (JAX's spectra, summed in float64
    and rounded once, so that the rows are sorted), the merge W_2^2 rows and
    the banded-plane beta cotangent for the row weight 1/rows."""
    import jax
    import jax.numpy as jnp

    from sot_tpu.ops.numerics import safe_divide
    from sot_tpu.ops.pallas.merge import sot_w2_merge
    from sot_tpu.ops.pallas.sot import _pallas_bwd
    from sot_tpu.training.trainer import forward

    x_hat = forward(mod, jax.tree.map(jnp.asarray, params), jnp.asarray(x))["x_hat"]
    n = len(mod.x_pos)
    sx = mod.transform(jnp.asarray(x)).reshape(-1, n) ** 2
    sy = mod.transform(x_hat).reshape(-1, n) ** 2
    mass = jnp.sum(sx, axis=1, keepdims=True)
    U, V = (jnp.asarray(np.cumsum(np.asarray(safe_divide(s, mass), np.float64), axis=-1)
                        .astype(np.float32)) for s in (sx, sy))
    cap = jnp.maximum(jnp.max(jnp.where(U <= 1.0, U, 0.0), axis=-1),
                      jnp.max(jnp.where(V <= 1.0, V, 0.0), axis=-1))[:, None]
    alpha = jnp.concatenate([jnp.minimum(U, cap), cap], axis=-1)
    beta = jnp.concatenate([jnp.minimum(V, cap), cap], axis=-1)
    grid = jnp.asarray(mod.x_pos)
    gaug = jnp.concatenate([grid, grid[-1:]])
    wbar = jnp.full((alpha.shape[0],), 1.0 / alpha.shape[0], jnp.float32)
    _, db = _pallas_bwd(alpha, beta, gaug, 2.0, wbar, alpha_grads=False)
    return {"sot_alpha": np.asarray(alpha), "sot_beta": np.asarray(beta),
            "sot_gaug": np.asarray(gaug),
            "sot_w": np.asarray(sot_w2_merge(alpha, beta, gaug, target_constant=True)),
            "sot_db": np.asarray(db)}


def generate() -> str:
    _set_gates()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from sot_tpu.configs import get_experiment
    from sot_tpu.data import SplitArrays
    from sot_tpu.training.trainer import build_modules, compute_loss, evaluate, make_eval_step

    params, step = restore_params()
    with np.load(PREDICT_GOLDEN) as z:
        x_all, f0 = z["x"], z["f0"]
    x = x_all[:N_CLIPS]
    mod = build_modules(get_experiment(EXPERIMENT))
    jparams = jax.tree.map(jnp.asarray, params)

    payload = {**flatten(params["params"]), "step": np.asarray(step, np.int64), "x": x,
               "gates": np.array(" ".join(f"{k}={v}" for k, v in sorted(GATES.items())))}
    for term, tag in TERMS.items():
        def loss_fn(p, term=term):
            _, (logs, _) = compute_loss(mod, p, jnp.asarray(x), train=False)
            return logs[term], logs

        (_, logs), grads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
        payload[f"loss_{tag}"] = np.float32(logs[term])
        payload.update({k.replace("params/", f"grad_{tag}/", 1): v for k, v in
                        flatten(jax.tree.map(np.asarray, grads["params"])).items()})
    payload.update(sot_rows(mod, params, x[:N_SOT_CLIPS]))
    split = SplitArrays(x_all, f0, np.zeros((len(x_all), 1), np.float32))
    metrics = evaluate(mod, make_eval_step(mod), jparams, split, len(x_all))
    payload.update({f"eval/{k}": np.float32(v) for k, v in metrics.items()})
    np.savez(GOLDEN, **payload)
    print(f"loss {float(payload['loss_total']):.8f} (MSS {float(payload['loss_mss']):.8f}, "
          f"W1D {float(payload['loss_w1d']):.8f}); eval "
          + ", ".join(f"{k} {float(v):.6f}" for k, v in metrics.items()))
    return GOLDEN


if __name__ == "__main__":
    print("wrote", generate())
