"""Kernel B8 (the SOT merge-coupling gradient) and the ``full`` route against
``sot_tpu.ops.pallas.merge``: ``coupling_grads``'s plain version against
``_coupling_grads_pallas``, and ``wasserstein_same_grid`` under
``KernelGates(w2_merge="full")`` against the JAX package's route under
``SOT_TPU_W2_MERGE=1``. The JAX kernels run in interpret mode, as the JAX
package's own tests run them.

The convention is min-halving at exact ties (``_merge_form_dense``,
``tests/test_sot_merge.py:77-95``): it is held against JAX's ``full``
route and the dense ``torch.minimum`` oracle, never against the plane
convention of the other routes. Gradients are compared unmasked, ties
included.

Tolerances: the coupling gradients bit for bit on grid deltas whose
prefix sums are exact (the plain version sums them in float64, the JAX
kernel in f32 Hillis-Steele scans), and within 1e-6 of the max against
the float64 dense oracle; route values within 3e-5 of the largest
marginal term (W = marginals - 2 x coupling cancels) and gradients within
3e-5 of their max (``tests/test_torch_plane.py``'s route bounds).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from sot_tpu.ops.pallas import merge as jmerge  # noqa: E402
from sot_tpu.ops.pallas import sot as jsot  # noqa: E402
from sot_tpu_torch.kernel_gates import KernelGates  # noqa: E402
from sot_tpu_torch.ops import wasserstein as tw  # noqa: E402
from sot_tpu_torch.ops.kernels import merge as kmerge  # noqa: E402
from test_sot_pallas import _make_case  # noqa: E402
from test_torch_plane import _assert_close, _spectra, _t  # noqa: E402
from test_torch_sot import _same_cap_rows  # noqa: E402

FULL = KernelGates(w2_merge="full")


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SOT_TPU_PALLAS_INTERPRET", "1")
    for k in ("SOT_TPU_W2_MERGE", "SOT_TPU_W2_MERGE_SMALL", "SOT_TPU_MERGE_ROWS"):
        monkeypatch.delenv(k, raising=False)


def _complements(seed, rows, n, v_mass=1.4):
    """(a, b, x) of ``tests/test_sot_merge.py``'s tie-heavy inputs (zero
    bins, the quantile cap): the nonincreasing complements of the clipped
    augmented CDFs, summed once in numpy, and the grid deltas."""
    grid, u, v = (np.asarray(t) for t in _make_case(seed, rows=rows, n=n, v_mass=v_mass,
                                                      zeros=True))
    alpha, beta, gaug = (t.numpy() for t in tw.clipped_cdfs(_t(grid), _t(u), _t(v), True))
    cap = alpha[:, -1:]
    return cap - alpha[:, :-1], cap - beta[:, :-1], gaug[1:] - gaug[:-1]


def test_coupling_grads_match_the_jax_kernel():
    """130 rows of ``test_sot_merge.py``'s tie-heavy inputs (two of JAX's
    128-row programs, a padded valley at n = 97) and 16 dyadic tie rows
    (``chip_smoke.dyadic_plane_rows``: plateaus, empty bins, a cap tail,
    every 7th row with beta = alpha), on grid deltas of multiples of 2^-10:
    the result depends on a and b only through their comparisons, and every
    prefix sum of such deltas is exact, so the two agree bit for bit, ties
    included. One JAX call (``alpha_grads`` only adds the alpha stream; db
    is the same), the port both ways."""
    a, b, x = _complements(118, 130, 97)
    alpha, beta, _, _ = chip_smoke.dyadic_plane_rows(np.random.default_rng(5), 16, 98)
    a = np.concatenate([a, alpha[:, -1:] - alpha[:, :-1]])
    b = np.concatenate([b, alpha[:, -1:] - beta[:, :-1]])
    x = (np.round(x * 1024.0) / 1024.0).astype(np.float32)
    jda, jdb = (np.asarray(t) for t in jmerge._coupling_grads_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(x), True))
    for alpha_grads in (True, False):
        da, db = kmerge.coupling_grads(_t(a), _t(b), _t(x), alpha_grads)
        np.testing.assert_array_equal(db.numpy(), jdb)
        if alpha_grads:
            np.testing.assert_array_equal(da.numpy(), jda)
        else:
            assert da is None
    # ties between the two sides (both saturate at the cap: a = b = 0)
    assert np.any(a[:, :, None] == b[:, None, :])


def test_coupling_grads_are_the_dense_min_halving_oracle():
    """Autograd of the dense sum of x_k x_l min(a_k, b_l) (``torch.minimum``
    splits ties 1/2, 1/2), in float64: sorted rows through the rank queries,
    and rows that are not sorted through the dense scan."""
    a, b, x = (t.astype(np.float64) for t in _complements(47, 12, 97))
    rng = np.random.default_rng(0)
    unsorted_a, unsorted_b = rng.permuted(a, axis=-1), rng.permuted(b, axis=-1)
    for aa, bb in ((a, b), (unsorted_a, b), (a, unsorted_b)):
        ta = torch.from_numpy(aa).requires_grad_(True)
        tb = torch.from_numpy(bb).requires_grad_(True)
        xx = torch.from_numpy(x)
        S = torch.sum(torch.minimum(ta[:, :, None], tb[:, None, :]) * xx[:, None] * xx[None, :])
        ga, gb = torch.autograd.grad(S, (ta, tb))
        da, db = kmerge.coupling_grads(*(t.to(torch.float32) for t in (ta.detach(),
                                                                       tb.detach(), xx)))
        _assert_close(da.numpy(), ga.numpy(), 1e-6)
        _assert_close(db.numpy(), gb.numpy(), 1e-6)


def _full_route_case(monkeypatch, target_constant, rows=12, n=97, seed=3):
    """(port (W, du, dv), JAX (W, du, dv), marginal scale) of the full route
    on lattice spectra (every CDF sum exact in both packages, so the cap and
    its ties are the same)."""
    grid, u, v = _spectra(rows, n, seed)
    v[::4] = u[::4]  # fully saturated rows: identical CDFs, every bin a tie
    assert _same_cap_rows(u, v, True).all()
    weights = np.random.default_rng(seed + 1).uniform(0.5, 1.5, rows).astype(np.float32)
    monkeypatch.setenv("SOT_TPU_W2_MERGE", "1")
    assert jsot._merge_mode(n) == "full"

    def jloss(uu, vv):
        w = jsot.wasserstein_same_grid(jnp.asarray(grid), uu, vv, p=2.0,
                                       limit_quantile_range=True,
                                       target_constant=target_constant)
        return jnp.sum(w * jnp.asarray(weights)), w

    (_, jw), (jgu, jgv) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(u), jnp.asarray(v))
    ut, vt = _t(u).requires_grad_(True), _t(v).requires_grad_(True)
    assert tw.w2_route(n, FULL) == "full"
    w = tw.wasserstein_same_grid(_t(grid), ut, vt, p=2.0, limit_quantile_range=True,
                                 target_constant=target_constant, kernels=FULL)
    torch.sum(w * _t(weights)).backward()
    alpha, beta, gaug = (t.numpy() for t in tw.clipped_cdfs(_t(grid), _t(u), _t(v), True))
    g2 = gaug ** 2
    marg = ((alpha - np.pad(alpha, ((0, 0), (1, 0)))[:, :-1]) @ g2
            + (beta - np.pad(beta, ((0, 0), (1, 0)))[:, :-1]) @ g2)
    port = (w.detach().numpy(), None if ut.grad is None else ut.grad.numpy(), vt.grad.numpy())
    return port, (np.asarray(jw), np.asarray(jgu), np.asarray(jgv)), float(marg.max())


@pytest.mark.parametrize("target_constant", [True, False])
def test_full_route_matches_jax(monkeypatch, target_constant):
    """Values and the u and v gradients of the ``full`` route, ties and the
    quantile cap included, and on fully saturated rows (W = 0, finite
    gradients; ``test_merge_kernel_exact_tie_rows_finite``); with a
    constant target the cap lane keeps its (sum x)^2 cotangent, which
    reaches v through the cap."""
    (w, gu, gv), (jw, jgu, jgv), marg = _full_route_case(monkeypatch, target_constant)
    np.testing.assert_allclose(w, jw, atol=3e-5 * marg, rtol=0)
    np.testing.assert_allclose(w[::4], 0.0, atol=1e-6)
    assert np.isfinite(gv).all()
    _assert_close(gv, jgv, 3e-5)
    if target_constant:
        assert gu is None and not np.any(jgu)
    else:
        _assert_close(gu, jgu, 3e-5)


def test_full_route_target_constant_is_the_stop_gradient_spec(monkeypatch):
    """``tests/test_sot_merge.py:129-147`` in the port: the v gradient with a
    constant target equals the full VJP with the alpha body (not its cap
    lane) cut from the graph."""
    grid, u, v = _spectra(8, 77, seed=29)

    def gv(tc):
        vt = _t(v).requires_grad_(True)
        alpha, beta, gaug = tw.clipped_cdfs(_t(grid), _t(u), vt, True)
        if not tc:
            alpha = torch.cat([alpha[:, :-1].detach(), alpha[:, -1:]], dim=-1)
        torch.sum(tw.sot_w2_merge_full(alpha, beta, gaug, target_constant=tc)).backward()
        return vt.grad.numpy()

    np.testing.assert_allclose(gv(True), gv(False), rtol=1e-6, atol=1e-8)


def test_coupling_grads_wrapper_takes_plain_version_on_cpu():
    a, b, x = (_t(t) for t in _complements(1, 4, 20))
    before = kmerge.grad_launches
    da, db = kmerge.coupling_grads(a, b, x, alpha_grads=False)
    assert da is None and db.shape == (4, 20) and kmerge.grad_launches == before
    with pytest.raises(ValueError, match="coupling_grads"):
        kmerge.coupling_grads(a.to("meta"), b.to("meta"), x.to("meta"))
