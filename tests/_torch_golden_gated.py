"""Generate the port's golden file of the gated SOT-2048 train step from the
JAX package (not a test module).

The gated step is the SOT-2048 train step with the JAX package's three
gated-off kernel switches on: the ``full`` merge route (``SOT_TPU_W2_MERGE=1``:
the merge-coupling value and its min-halving gradient), the fused STFT
frontend (``SOT_TPU_STFT_PALLAS=1``) and the k = 15 conv kernels
(``SOT_TPU_CONV_PALLAS=1``, at the default bf16 operand type), with the
shipped synth kernel (``SOT_TPU_SYNTH_PALLAS=1``) as in
``tests/_torch_golden_train.py``, all in interpret mode on the CPU. The port
runs the same step with ``KernelGates(w2_merge="full", conv=True,
stft_frontend=True)``.

Takes the committed SOT-2048 seed-42 weights and the first 16 clips of
``sot_tpu_torch/golden/sot2048_seed42_predict.npz``, computes
``compute_loss`` in eval mode and writes

    sot_tpu_torch/golden/sot2048_seed42_trainstep_gated.npz

with ``x`` [16, 4096], ``loss_total``, ``loss_mss``, ``loss_w1d``, each
term's gradient per parameter leaf (``grad_<term>/<flax path>``), the
``gates`` used and, for the first 8 clips (128 rows), the clipped CDFs of
the gated model's SOT spectra (``sot_alpha``, ``sot_beta``, ``sot_gaug``;
float64 sums rounded once, as ``_torch_golden_train.sot_rows`` builds
them), the merge route's W_2^2 rows (``sot_w``) and the coupling gradient
of the merge kernel ``_coupling_grads_pallas`` (``sot_db`` [128, 1024]:
dS/db of S = sum x_k x_l min(a_k, b_l), a = cap - alpha, b = cap - beta,
without alpha gradients, on the shaved columns the ``full`` route gives
it); and for the first 4 clips (64 rows) the ``full`` route end to end on
JAX's own normalised spectra (``route_u``, ``route_v``, ``route_w``,
``route_dv``, ``route_cap``; see ``route_rows``), where the rows whose
quantile cap moves between the JAX package's blocked f32 prefix sum and
the port's float64 one can be told apart from the rest.

    JAX_PLATFORMS=cpu python -m tests._torch_golden_gated
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from tests import _torch_golden_train as train_golden
from tests._torch_golden import GOLDEN as PREDICT_GOLDEN
from tests._torch_golden import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot2048_seed42_trainstep_gated.npz")
GATES: Dict[str, str] = {
    "SOT_TPU_W2_MERGE": "1",
    "SOT_TPU_MERGE_ROWS": "128",
    "SOT_TPU_STFT_PALLAS": "1",
    "SOT_TPU_CONV_PALLAS": "1",
    "SOT_TPU_SYNTH_PALLAS": "1",
    "SOT_TPU_PALLAS_INTERPRET": "1",
}
N_ROUTE_CLIPS = 4  # clips whose SOT rows go through the full route end to end (64 rows)


def _set_gates() -> None:
    for k in [k for k in os.environ if k.startswith("SOT_TPU_")]:
        del os.environ[k]
    os.environ.update(GATES)


def coupling_grad_rows(rows: Dict[str, np.ndarray]) -> np.ndarray:
    """The merge kernel's dS/db on the rows' complements, as the ``full``
    route calls it (``merge.py:sot_w2_merge``: the last column, whose grid
    delta is 0, shaved)."""
    import jax.numpy as jnp

    from sot_tpu.ops.pallas.merge import _coupling_grads_pallas

    alpha, beta, gaug = rows["sot_alpha"], rows["sot_beta"], rows["sot_gaug"]
    cap = alpha[:, -1:]
    a, b, x = cap - alpha[:, :-1], cap - beta[:, :-1], gaug[1:] - gaug[:-1]
    _, db = _coupling_grads_pallas(jnp.asarray(a[:, :-1]), jnp.asarray(b[:, :-1]),
                                   jnp.asarray(x[:-1]), False)
    return np.asarray(db)


def route_rows(params, x: np.ndarray) -> Dict[str, np.ndarray]:
    """The ``full`` route end to end on JAX's own SOT rows of ``x``: the
    normalised spectra u (target) and v (estimate) [rows, 1025], the JAX
    package's W_2^2 per row (``route_w``), its v cotangent for the mean's
    row weight 1/rows with a constant target (``route_dv``) and its
    quantile cap per row (``route_cap``, from its blocked f32 prefix sum)."""
    import jax
    import jax.numpy as jnp

    from sot_tpu.configs import get_experiment
    from sot_tpu.ops.numerics import safe_divide
    from sot_tpu.ops.pallas.sot import wasserstein_same_grid
    from sot_tpu.ops.scan import prefix_sum
    from sot_tpu.training.trainer import build_modules, forward

    mod = build_modules(get_experiment("SOT-2048"))
    x_hat = forward(mod, jax.tree.map(jnp.asarray, params), jnp.asarray(x))["x_hat"]
    n = len(mod.x_pos)
    sx = mod.transform(jnp.asarray(x)).reshape(-1, n) ** 2
    sy = mod.transform(x_hat).reshape(-1, n) ** 2
    mass = jnp.sum(sx, axis=1, keepdims=True)
    u, v = safe_divide(sx, mass), safe_divide(sy, mass)
    grid = jnp.asarray(mod.x_pos)
    rows = u.shape[0]

    def loss(vv):
        w = wasserstein_same_grid(grid, u, vv, p=2.0, limit_quantile_range=True,
                                  target_constant=True)
        return jnp.mean(w), w

    (_, w), dv = jax.value_and_grad(loss, has_aux=True)(v)
    U, V = prefix_sum(u, axis=-1), prefix_sum(v, axis=-1)
    cap = jnp.maximum(jnp.max(jnp.where(U <= 1.0, U, 0.0), axis=-1),
                      jnp.max(jnp.where(V <= 1.0, V, 0.0), axis=-1))
    assert rows == len(x) * 16
    return {"route_u": np.asarray(u), "route_v": np.asarray(v), "route_w": np.asarray(w),
            "route_dv": np.asarray(dv), "route_cap": np.asarray(cap)}


def generate() -> str:
    _set_gates()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from sot_tpu.configs import get_experiment
    from sot_tpu.ops.pallas.sot import _merge_mode
    from sot_tpu.training.trainer import build_modules, compute_loss
    from sot_tpu_torch.convert import flax_tree_from_flat

    assert _merge_mode(1025) == "full"
    with np.load(PREDICT_GOLDEN) as z:
        params = flax_tree_from_flat({k: z[k] for k in z.files})
        x = z["x"][:train_golden.N_CLIPS]
    mod = build_modules(get_experiment("SOT-2048"))

    payload = {"x": x,
               "gates": np.array(" ".join(f"{k}={v}" for k, v in sorted(GATES.items())))}
    for term, tag in train_golden.TERMS.items():
        def loss_fn(p, term=term):
            _, (logs, _) = compute_loss(mod, p, jnp.asarray(x), train=False)
            return logs[term], logs

        (_, logs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, params))
        payload[f"loss_{tag}"] = np.float32(logs[term])
        payload.update({k.replace("params/", f"grad_{tag}/", 1): v for k, v in
                        flatten(jax.tree.map(np.asarray, grads["params"])).items()})
    rows = train_golden.sot_rows(params, x[:train_golden.N_SOT_CLIPS])
    rows["sot_db"] = coupling_grad_rows(rows)
    payload.update(rows)
    payload.update(route_rows(params, x[:N_ROUTE_CLIPS]))
    np.savez(GOLDEN, **payload)
    print(f"loss {float(payload['loss_total']):.8f} (MSS {float(payload['loss_mss']):.8f}, "
          f"W1D {float(payload['loss_w1d']):.8f})")
    return GOLDEN


if __name__ == "__main__":
    print("wrote", generate())
