"""Generate the port's train-step golden file from the JAX package (not a
test module).

Takes the committed SOT-2048 seed-42 weights and the first 16 clips of
``sot_tpu_torch/golden/sot2048_seed42_predict.npz`` (``tests/_torch_golden.py``
made both), and computes with ``sot_tpu.training.trainer.compute_loss`` on
the CPU, in eval mode, the SOT-2048 loss, its two terms and the gradient of
every encoder parameter. The JAX package runs with the shipped kernel gates
in interpret mode, except the two that only change precision
(``SOT_TPU_CQT_PALLAS``'s bf16 operands and ``SOT_TPU_CONV_BF16``): the
port is float32 throughout. Writes

    sot_tpu_torch/golden/sot2048_seed42_trainstep.npz

with ``x`` [16, 4096], ``loss_total``, ``loss_mss``, ``loss_w1d`` (the
weighted terms), the gradient of each per parameter leaf
(``grad_total/<flax path>``, ``grad_mss/...``, ``grad_w1d/...``) and the
gates used; and, for the first 8 clips, the SOT kernels on real rows: the
clipped CDFs of JAX's spectra and the grid (``sot_alpha``, ``sot_beta``,
``sot_gaug``),
the merge route's W_2^2 rows (``sot_w``) and the refgrad cotangent
(``sot_db``), so that the port's kernels can be held to JAX's on identical
inputs, where the gradient convention must match exactly. The terms' gradients are kept apart because the MSS term is an
L1 distance: at bins where the target and the estimate agree to within
rounding its sign, and so its gradient, differs between any two
implementations.

It also counts the cap-rounding rows of a real SOT-2048 batch: with the
quantile cutoff, the cap is the largest CDF value <= 1, and the target's
self-normalised CDF ends within an ulp of 1.0; whether that last value
counts depends on the summation order. On all 64 golden clips (1024 rows of
the flattop 2048/256 spectra of x and the model's x_hat) it compares the
cap from the JAX package's blocked f32 prefix sum with the cap from a
float64 cumulative sum rounded once to f32 (the port's ``prefix_sum``) and
stores ``cap_rows`` (rows compared), ``cap_rows_differ`` (any difference),
``cap_rows_jump`` (a difference above 1e-6 relative: another CDF value
became the cap), ``cap_jump_max_rel`` (the largest relative difference) and
``cdf_rows_decreasing`` (target CDF rows that the JAX prefix sum makes step
down somewhere, which a CDF of non-negative weights never does).

    JAX_PLATFORMS=cpu python -m tests._torch_golden_train
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from tests._torch_golden import GOLDEN as PREDICT_GOLDEN
from tests._torch_golden import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot2048_seed42_trainstep.npz")
N_CLIPS = 16
GATES: Dict[str, str] = {
    "SOT_TPU_W2_MERGE": "ref",
    "SOT_TPU_MERGE_ROWS": "128",
    "SOT_TPU_W2_MERGE_SMALL": "hybrid",
    "SOT_TPU_SYNTH_PALLAS": "1",
    "SOT_TPU_PALLAS_INTERPRET": "1",
}
# the loss and its two weighted terms, each with its own gradient
TERMS = {"loss/total": "total", "loss/MSSLoss": "mss", "loss/Wasserstein1D": "w1d"}
N_SOT_CLIPS = 8  # clips whose SOT rows are stored (128 rows of 1026 lanes)


def _set_gates() -> None:
    for k in [k for k in os.environ if k.startswith("SOT_TPU_")]:
        del os.environ[k]
    os.environ.update(GATES)


def _cap(U, V):
    """Each row's quantile cap: the largest CDF value <= 1 of either CDF."""
    return np.maximum(np.where(U <= 1.0, U, 0.0).max(-1), np.where(V <= 1.0, V, 0.0).max(-1))


def sot_rows(params, x: np.ndarray) -> Dict[str, np.ndarray]:
    """The SOT kernels' inputs and outputs on real rows: the clipped
    augmented CDFs alpha, beta [rows, 1026] and grid of the batch's SOT-2048
    loss (JAX's spectra; the CDFs summed in float64 and clipped as
    ``sot_tpu.ops.pallas.sot.wasserstein_same_grid`` clips them),
    the W_2^2 rows of the merge route and the reference-convention beta
    cotangent for the mean's row weight 1/rows, both from the Pallas
    kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    from sot_tpu.configs import get_experiment
    from sot_tpu.ops.numerics import safe_divide
    from sot_tpu.ops.pallas.merge import sot_w2_merge
    from sot_tpu.ops.pallas.refgrad import ref_grad_beta
    from sot_tpu.training.trainer import build_modules, forward

    mod = build_modules(get_experiment("SOT-2048"))
    x_hat = forward(mod, jax.tree.map(jnp.asarray, params), jnp.asarray(x))["x_hat"]
    n = len(mod.x_pos)
    sx = mod.transform(jnp.asarray(x)).reshape(-1, n) ** 2
    sy = mod.transform(x_hat).reshape(-1, n) ** 2
    mass = jnp.sum(sx, axis=1, keepdims=True)
    # monotone CDFs (float64 sums rounded once): the JAX package's blocked
    # f32 prefix sum can step down by an ulp at its 128-lane chunk
    # boundaries, and the kernels' rank queries assume sorted rows
    U, V = (jnp.asarray(np.cumsum(np.asarray(safe_divide(s, mass), np.float64), axis=-1)
                        .astype(np.float32)) for s in (sx, sy))
    cap = jnp.maximum(jnp.max(jnp.where(U <= 1.0, U, 0.0), axis=-1),
                      jnp.max(jnp.where(V <= 1.0, V, 0.0), axis=-1))[:, None]
    alpha = jnp.concatenate([jnp.minimum(U, cap), cap], axis=-1)
    beta = jnp.concatenate([jnp.minimum(V, cap), cap], axis=-1)
    grid = jnp.asarray(mod.x_pos)
    gaug = jnp.concatenate([grid, grid[-1:]])
    wbar = jnp.full((alpha.shape[0],), 1.0 / alpha.shape[0], jnp.float32)
    return {"sot_alpha": np.asarray(alpha), "sot_beta": np.asarray(beta),
            "sot_gaug": np.asarray(gaug),
            "sot_w": np.asarray(sot_w2_merge(alpha, beta, gaug, target_constant=True)),
            "sot_db": np.asarray(ref_grad_beta(alpha, beta, gaug, wbar))}


def cap_rounding_rows(params, x: np.ndarray) -> Dict[str, int]:
    """Rows of the batch's SOT spectra whose cap differs between the JAX
    package's prefix sum and a float64 cumulative sum rounded to f32."""
    import jax
    import jax.numpy as jnp

    from sot_tpu.configs import get_experiment
    from sot_tpu.ops.numerics import safe_divide
    from sot_tpu.ops.scan import prefix_sum
    from sot_tpu.training.trainer import build_modules, forward

    mod = build_modules(get_experiment("SOT-2048"))
    x_hat = forward(mod, jax.tree.map(jnp.asarray, params), jnp.asarray(x))["x_hat"]
    sx = np.asarray(mod.transform(jnp.asarray(x)) ** 2).reshape(-1, 1025)
    sy = np.asarray(mod.transform(x_hat) ** 2).reshape(-1, 1025)
    # Wasserstein1D's normalisation: square_dist, x self-normalised, y by x's mass
    mass = sx.sum(-1, keepdims=True)
    u = np.asarray(safe_divide(jnp.asarray(sx), jnp.asarray(mass)))
    v = np.asarray(safe_divide(jnp.asarray(sy), jnp.asarray(mass)))

    U, V = (np.asarray(prefix_sum(jnp.asarray(w), axis=-1)) for w in (u, v))
    decreasing = int(np.count_nonzero((np.diff(U, axis=-1) < 0).any(-1)))
    cap_jax = _cap(U, V)
    cap_f64 = _cap(*(np.cumsum(w.astype(np.float64), -1).astype(np.float32) for w in (u, v)))
    d = np.abs(cap_jax - cap_f64)
    rel = d / cap_f64
    return {"cap_rows": int(len(d)), "cap_rows_differ": int(np.count_nonzero(d)),
            "cap_rows_jump": int(np.count_nonzero(rel > 1e-6)),
            "cap_jump_max_rel": float(rel.max()), "cdf_rows_decreasing": decreasing}


def generate() -> str:
    _set_gates()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from sot_tpu.configs import get_experiment
    from sot_tpu.training.trainer import build_modules, compute_loss
    from sot_tpu_torch.convert import flax_tree_from_flat

    with np.load(PREDICT_GOLDEN) as z:
        params = flax_tree_from_flat({k: z[k] for k in z.files})
        x_all = z["x"]
    x = x_all[:N_CLIPS]
    mod = build_modules(get_experiment("SOT-2048"))

    payload = {"x": x,
               "gates": np.array(" ".join(f"{k}={v}" for k, v in sorted(GATES.items())))}
    for term, tag in TERMS.items():
        def loss_fn(p, term=term):
            _, (logs, _) = compute_loss(mod, p, jnp.asarray(x), train=False)
            return logs[term], logs

        (_, logs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, params))
        payload[f"loss_{tag}"] = np.float32(logs[term])
        payload.update({k.replace("params/", f"grad_{tag}/", 1): v for k, v in
                        flatten(jax.tree.map(np.asarray, grads["params"])).items()})
    loss = payload["loss_total"]
    payload.update(sot_rows(params, x[:N_SOT_CLIPS]))
    counts = cap_rounding_rows(params, x_all)
    payload.update({k: np.asarray(v) for k, v in counts.items()})
    np.savez(GOLDEN, **payload)
    print(f"loss {float(loss):.8f} (MSS {float(payload['loss_mss']):.8f}, W1D "
          f"{float(payload['loss_w1d']):.8f}); cap rows of {len(x_all)} clips: {counts}")
    return GOLDEN


if __name__ == "__main__":
    print("wrote", generate())
