"""The port's loss objects against ``sot_tpu.losses``: ``mean_difference``,
``MSSLoss`` and ``Wasserstein1D`` (normalisation rules, ``square_dist``,
same-grid detection on a sorted numpy grid, hinge, mean over rows), values
and gradients, on numpy-seeded spectra and audio.

Tolerances: values rtol 1e-5; gradients max|d| <= 2e-5 * max|ref| (f32
sums in other orders; for the MSS, FFTs of two libraries). With the
quantile cutoff, a row whose cap jumps between the two packages' CDF
summation orders (the target's CDF ends within an ulp of 1.0 and rounds to
either side) integrates over another quantile range: such rows are left
out of the comparison, and at most half of them may be
(``tests/test_torch_sot.py`` feeds both packages the same CDFs instead).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu import losses as jlosses  # noqa: E402
from sot_tpu_torch import losses as tlosses  # noqa: E402
from tests._torch_parity import rel_max_err  # noqa: E402


@pytest.fixture(autouse=True)
def _no_gates(monkeypatch):
    for k in ("SOT_TPU_W2_MERGE", "SOT_TPU_W2_MERGE_SMALL", "SOT_TPU_FORCE_GENERAL"):
        monkeypatch.delenv(k, raising=False)


def _vg_jax(fn, *args, jit=False):
    """Value and gradient w.r.t. the last argument. ``jit`` compiles one
    program (fast) but lets XLA reorder sums, so the cap-jump rows found
    eagerly no longer apply: the SOT cases run eagerly."""
    vg = jax.value_and_grad(lambda last: fn(*args[:-1], last))
    val, g = (jax.jit(vg) if jit else vg)(jnp.asarray(args[-1]))
    return float(val), np.asarray(g)


def _vg_port(fn, *args):
    last = torch.from_numpy(np.array(args[-1])).requires_grad_(True)
    val = fn(*(torch.from_numpy(np.array(a)) for a in args[:-1]), last)
    val.backward()
    return float(val.detach()), last.grad.numpy()


@pytest.mark.parametrize("loss_type", ["L1", "L2", "l1"])
def test_mean_difference(loss_type):
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((3, 7)).astype(np.float32) for _ in range(2))
    w = rng.random((3, 7)).astype(np.float32)
    for weights in (None, w):
        ref = jlosses.mean_difference(jnp.asarray(a), jnp.asarray(b), loss_type,
                                      None if weights is None else jnp.asarray(weights))
        got = tlosses.mean_difference(torch.from_numpy(a), torch.from_numpy(b), loss_type,
                                      None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    with pytest.raises(ValueError):
        tlosses.mean_difference(torch.zeros(1), torch.zeros(1), "L3")


@pytest.mark.parametrize("mag,logmag,loss_type", [(1.0, 0.0, "L1"), (1.0, 1.0, "L1"),
                                                  (0.5, 0.0, "L2")])
def test_mss_loss_value_and_gradient(mag, logmag, loss_type):
    rng = np.random.default_rng(1)
    target = rng.uniform(-0.9, 0.9, (2, 4096)).astype(np.float32)
    audio = rng.uniform(-0.9, 0.9, (2, 4096)).astype(np.float32)
    kw = dict(mag_weight=mag, logmag_weight=logmag, loss_type=loss_type)
    v_ref, g_ref = _vg_jax(jlosses.MSSLoss(**kw), target, audio, jit=True)
    v, g = _vg_port(tlosses.MSSLoss(**kw), target, audio)
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    assert rel_max_err(g, g_ref) <= 2e-5


def _rows_with_same_cap(fn, x, y):
    """x, y [rows, n] -> the rows whose cap is the same (1e-6 rel) under the
    JAX package's prefix sum and the port's float64 one."""
    from sot_tpu.ops.numerics import safe_divide
    from sot_tpu.ops.scan import prefix_sum as jprefix

    if not fn.limit_quantile_range:
        return np.ones(len(x), bool)
    u, v = (t.numpy() for t in fn.normalize(torch.from_numpy(x), torch.from_numpy(y)))
    # the JAX package normalises in its own arithmetic
    jx, jy = (jnp.asarray(a) ** 2 if fn.square_dist else jnp.asarray(a) for a in (x, y))
    mass = jnp.sum(jx, axis=1, keepdims=True)
    ju, jv = safe_divide(jx, mass), safe_divide(jy, mass)

    def cap(U, V):
        return np.maximum(np.where(U <= 1, U, 0).max(-1), np.where(V <= 1, V, 0).max(-1))

    cj = cap(np.asarray(jprefix(ju, axis=-1)), np.asarray(jprefix(jv, axis=-1)))
    ct = cap(np.cumsum(u.astype(np.float64), -1).astype(np.float32),
             np.cumsum(v.astype(np.float64), -1).astype(np.float32))
    same = np.abs(cj - ct) <= 1e-6 * ct
    assert same.sum() >= len(x) // 2, f"the cap jumps on rows {np.flatnonzero(~same)}"
    return same


def _spectra(seed, shape=(2, 5, 65)):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32) + 0.05
    y = rng.random(shape).astype(np.float32) * 1.3 + 0.05
    return x, y


@pytest.mark.parametrize("kw", [
    dict(p=2, square_dist=True, dont_normalize=True, limit_quantile_range=True),  # SOT-2048
    dict(p=2, dont_normalize=False, limit_quantile_range=False),                   # SOT-NoCut
    dict(p=1, square_dist=True, dont_normalize=True, limit_quantile_range=True),
    dict(p=1, hinge=True),
])
def test_wasserstein1d_same_grid_value_and_gradient(kw):
    """One shared sorted numpy grid: the same-grid path in both packages
    (with ``target_constant``, the training setting). JAX runs its default
    CPU path; its merge kernels' interpret mode is covered in
    ``tests/test_torch_sot.py``."""
    x, y = (a.reshape(-1, a.shape[-1]) for a in _spectra(2, shape=(4, 5, 65)))
    pos = np.linspace(0.0, 1.0, x.shape[-1], dtype=np.float32)
    kw = dict(kw, target_constant=kw["p"] == 2)
    call = dict(x_pos=pos, y_pos=pos, hinge=0.01) if kw.get("hinge") else dict(x_pos=pos, y_pos=pos)
    jfn, tfn = jlosses.Wasserstein1D(**kw), tlosses.Wasserstein1D(**kw)
    same = _rows_with_same_cap(tfn, x, y)
    x, y = x[same], y[same]
    v_ref, g_ref = _vg_jax(lambda a, b: jfn(a, b, **call), x, y)
    v, g = _vg_port(lambda a, b: tfn(a, b, **call), x, y)
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    assert rel_max_err(g, g_ref) <= 2e-5


def test_wasserstein1d_general_path():
    """Unsorted or per-row positions take the sorting path: values and the
    gradient to the estimate, and the quantiles it returns."""
    x, y = _spectra(3, shape=(2, 4, 33))
    rng = np.random.default_rng(4)
    pos = rng.random(33).astype(np.float32)  # not sorted: no same-grid path
    jfn = jlosses.Wasserstein1D(p=2, square_dist=True)
    tfn = tlosses.Wasserstein1D(p=2, square_dist=True)
    v_ref, g_ref = _vg_jax(lambda a, b: jfn(a, b, x_pos=pos, y_pos=pos), x, y)
    v, g = _vg_port(lambda a, b: tfn(a, b, x_pos=pos, y_pos=pos), x, y)
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    assert rel_max_err(g, g_ref) <= 2e-5
    q_ref = jfn(jnp.asarray(x), jnp.asarray(y), x_pos=pos, y_pos=pos, return_quantiles=True)
    q = tfn(torch.from_numpy(x), torch.from_numpy(y), x_pos=pos, y_pos=pos,
            return_quantiles=True)
    for a, b in zip(q, q_ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-7)


def test_wasserstein1d_fixed_x_and_missing_positions():
    x, y = _spectra(5, shape=(2, 3, 17))
    v_ref = float(jlosses.Wasserstein1D(p=1, fixed_x=17)(jnp.asarray(x), jnp.asarray(y)))
    v = float(tlosses.Wasserstein1D(p=1, fixed_x=17)(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    with pytest.raises(ValueError, match="fixed_x"):
        tlosses.Wasserstein1D()(torch.from_numpy(x), torch.from_numpy(y))
