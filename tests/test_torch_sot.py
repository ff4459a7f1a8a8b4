"""The port's same-grid SOT path against ``sot_tpu.ops.pallas``: the B4
coupling's plain version, the B5 reference-convention gradient's plain
version, and ``wasserstein_same_grid`` (the ``ref`` mode: merge-coupling
forward, rank-query backward); the banded-plane routes are in
``tests/test_torch_plane.py``.

The JAX kernels run as the JAX package's own tests run them on the CPU
(``SOT_TPU_PALLAS_INTERPRET=1``). Gradients are compared UNMASKED, kinks
included: every real training row sits on the quantile cap's ties, and the
gradient convention there is what training depends on (PERF.md, "The
gradient-convention lesson").

Tolerances: the coupling S within 2e-6 of max|S| (f32 inputs; the plain
version sums in float64, the JAX kernel in f32 prefix sums); W_2^2 within
3e-5 of max(marginal terms) (W = marg - 2*cross cancels as the spectra
converge, so its error is relative to what it is computed from); beta
gradients within 2e-5 * max|ref| (``tests/test_refgrad.py``'s bound).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.ops.pallas import merge as jmerge  # noqa: E402
from sot_tpu.ops.pallas import refgrad as jrefgrad  # noqa: E402
from sot_tpu.ops.pallas import sot as jsot  # noqa: E402
from sot_tpu.ops import wasserstein as jw  # noqa: E402
from sot_tpu_torch.ops import wasserstein as tw  # noqa: E402
from sot_tpu_torch.ops.kernels import merge as kmerge  # noqa: E402
from sot_tpu_torch.ops.kernels import plane as kplane  # noqa: E402
from sot_tpu_torch.ops.kernels import refgrad as krefgrad  # noqa: E402
from test_sot_pallas import _make_case as _sot_pallas_case  # noqa: E402


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SOT_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("SOT_TPU_W2_MERGE", raising=False)
    monkeypatch.delenv("SOT_TPU_W2_MERGE_SMALL", raising=False)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _make_case(seed, rows=12, n=97, v_mass=1.0):
    """``tests/test_sot_pallas.py``'s inputs as numpy: random weights with
    zero bins, u normalised, v at total mass ``v_mass``."""
    return tuple(np.asarray(a) for a in _sot_pallas_case(seed, rows=rows, n=n, v_mass=v_mass))


def _alpha_beta(grid, u, v, lqr):
    """The clipped augmented CDFs, computed once in numpy (f32) and handed
    to both packages, so the kernels see identical inputs."""
    U = np.cumsum(u, -1, dtype=np.float32)
    V = np.cumsum(v, -1, dtype=np.float32)
    if lqr:
        cap = np.maximum(np.where(U <= 1.0, U, 0.0).max(-1),
                         np.where(V <= 1.0, V, 0.0).max(-1))[:, None]
    else:
        cap = np.maximum(U[:, -1], V[:, -1])[:, None]
    alpha = np.concatenate([np.minimum(U, cap), cap], -1).astype(np.float32)
    beta = np.concatenate([np.minimum(V, cap), cap], -1).astype(np.float32)
    return alpha, beta, np.concatenate([grid, grid[-1:]]).astype(np.float32)


def _tie_heavy(seed=0, rows=4, n=32):
    """``tests/test_refgrad.py``'s tie-heavy case: integer weights give
    duplicate CDF plateaus, equal alpha/beta values and many empty bins."""
    rng = np.random.default_rng(seed)
    grid = np.sort(rng.random(n)).astype(np.float32)
    u = rng.integers(0, 3, (rows, n)).astype(np.float32)
    v = rng.integers(0, 3, (rows, n)).astype(np.float32)
    u /= u.sum(-1, keepdims=True)
    v /= v.sum(-1, keepdims=True) / 1.5
    return grid, u, v


def _cases():
    out = []
    for lqr in (False, True):
        for v_mass in (1.0, 1.9):
            out.append(("random", lqr, v_mass))
    out.append(("ties", True, 1.5))
    return out


def _case_inputs(kind, lqr, v_mass):
    if kind == "ties":
        grid, u, v = _tie_heavy()
    else:
        grid, u, v = _make_case(5, rows=9, n=97, v_mass=v_mass)
    alpha, beta, gaug = _alpha_beta(grid, u, v, lqr)
    wbar = (np.random.default_rng(2).random(len(alpha)) + 0.5).astype(np.float32)
    return alpha, beta, gaug, wbar


def _assert_close(got, want, tol):
    scale = float(np.max(np.abs(want))) + 1e-9
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol * scale, rtol=0)


# --- B4: the coupling value -------------------------------------------------


def _coupling_inputs(alpha, gaug):
    return alpha[:, -1:], gaug[1:] - gaug[:-1]


@pytest.mark.parametrize("kind,lqr,v_mass", _cases())
def test_coupling_plain_matches_dense_sum(kind, lqr, v_mass):
    """S against sum_{k,l} x_k x_l min(a_k, b_l) summed densely in float64."""
    alpha, beta, gaug, _ = _case_inputs(kind, lqr, v_mass)
    cap, x = _coupling_inputs(alpha, gaug)
    a, b = cap - alpha[:, :-1], cap - beta[:, :-1]
    x64 = x.astype(np.float64)
    ref = np.einsum("k,l,rkl->r", x64, x64,
                    np.minimum(a[:, :, None], b[:, None, :]).astype(np.float64))
    got = kmerge.coupling(_t(a), _t(b), _t(x)).numpy()
    assert got.shape == ref.shape == (len(a),)
    assert np.all(got >= 0.0)
    _assert_close(got, ref, 2e-6)


def test_coupling_plain_matches_jax_kernel():
    """Against the TPU kernel itself (interpret mode), tie-heavy rows."""
    alpha, beta, gaug, _ = _case_inputs("ties", True, 1.5)
    cap, x = _coupling_inputs(alpha, gaug)
    a, b = cap - alpha[:, :-1], cap - beta[:, :-1]
    ref = np.asarray(jax.jit(jmerge._coupling_fwd_pallas)(jnp.asarray(a), jnp.asarray(b),
                                                          jnp.asarray(x)))
    _assert_close(kmerge.coupling(_t(a), _t(b), _t(x)).numpy(), ref, 2e-6)


@pytest.mark.parametrize("kind,lqr,v_mass", _cases())
def test_sot_w2_merge_matches_jax(kind, lqr, v_mass):
    """W_2^2 rows against the sort-merge oracle and the dense O(n^2) overlap
    form of both packages, and (one case) the JAX merge kernel's wrapper."""
    alpha, beta, gaug, _ = _case_inputs(kind, lqr, v_mass)
    ja, jb, jg = (jnp.asarray(v) for v in (alpha, beta, gaug))
    got = kmerge.sot_w2_merge(_t(alpha), _t(beta), _t(gaug)).numpy()
    marg = ((alpha - np.pad(alpha, ((0, 0), (1, 0)))[:, :-1]) @ gaug ** 2
            + (beta - np.pad(beta, ((0, 0), (1, 0)))[:, :-1]) @ gaug ** 2)
    tol = 3e-5 * float(marg.max())
    refs = [jsot._sot_w2_sortmerge(ja, jb, jg), jsot._sot_bilinear_xla(ja, jb, jg, 2.0),
            kplane.sot_plane_forward_plain(_t(alpha), _t(beta), _t(gaug), 2.0).numpy()]
    if kind == "ties":
        refs.append(jax.jit(jmerge.sot_w2_merge, static_argnums=3)(ja, jb, jg, True))
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=0)


# --- B5: the reference-convention beta cotangent ----------------------------


@pytest.mark.parametrize("kind,lqr,v_mass", _cases())
def test_ref_grad_plain_matches_jax(kind, lqr, v_mass):
    """Against the O(n^2) plane oracle and the rank-query closed form of the
    JAX package, the port's own dense oracle, and (tie-heavy case) the TPU
    kernel in interpret mode."""
    alpha, beta, gaug, wbar = _case_inputs(kind, lqr, v_mass)
    j = [jnp.asarray(v) for v in (alpha, beta, gaug, wbar)]
    got = krefgrad.ref_grad_beta(*(_t(v) for v in (alpha, beta, gaug, wbar))).numpy()
    dense = np.asarray(jrefgrad.plane_grad_beta_dense(*j))
    _assert_close(got, dense, 2e-5)
    _assert_close(got, np.asarray(jrefgrad.ref_grad_beta_xla(*j)), 2e-5)
    _, port_dense = kplane.sot_plane_backward_plain(_t(alpha), _t(beta), _t(gaug), 2.0,
                                                    _t(wbar), alpha_grads=False)
    _assert_close(port_dense.numpy(), dense, 2e-5)
    if kind == "ties":
        _assert_close(got, np.asarray(jax.jit(jrefgrad.ref_grad_beta)(*j)), 2e-5)


# --- the same-grid entry point ----------------------------------------------


def _jax_value_and_grad(monkeypatch, grid, u, v, lqr, mode, weights):
    def loss(vv):
        w = jsot.wasserstein_same_grid(jnp.asarray(grid), jnp.asarray(u), vv, p=2.0,
                                       limit_quantile_range=lqr, target_constant=True)
        return jnp.sum(w * jnp.asarray(weights)), w

    monkeypatch.setenv("SOT_TPU_W2_MERGE", mode)
    # eager, as _same_cap_rows computes JAX's CDFs (jit may reorder the sums)
    (_, w), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(v))
    return np.asarray(w), np.asarray(g)


def _port_value_and_grad(grid, u, v, lqr, weights):
    vt = _t(v).requires_grad_(True)
    w = tw.wasserstein_same_grid(_t(grid), _t(u), vt, p=2.0, limit_quantile_range=lqr,
                                 target_constant=True)
    torch.sum(w * _t(weights)).backward()
    return w.detach().numpy(), vt.grad.numpy()


def _same_cap_rows(u, v, lqr):
    """Rows whose cap agrees (to 1e-6 relative) whether the CDFs are summed
    in float64 (the port) or in JAX's blocked f32 order. With the quantile
    cutoff, a CDF value within an ulp of 1.0 can round to either side, and
    the cap then jumps to another CDF value: such a row integrates over a
    different quantile range in the two packages."""
    from sot_tpu.ops.scan import prefix_sum as jprefix

    def cap(U, V):
        if not lqr:
            return np.maximum(U[:, -1], V[:, -1])
        return np.maximum(np.where(U <= 1, U, 0).max(-1), np.where(V <= 1, V, 0).max(-1))

    cj = cap(np.asarray(jprefix(jnp.asarray(u), axis=-1)),
             np.asarray(jprefix(jnp.asarray(v), axis=-1)))
    ct = cap(np.cumsum(u.astype(np.float64), -1).astype(np.float32),
             np.cumsum(v.astype(np.float64), -1).astype(np.float32))
    return np.abs(cj - ct) <= 1e-6 * np.abs(ct)


@pytest.mark.parametrize("mode,lqr", [("", False), ("", True), ("ref", True)])
def test_wasserstein_same_grid_matches_jax(monkeypatch, mode, lqr):
    """Values and beta gradients through the real entry points, against
    JAX's default (banded-plane) path and its shipped ``ref`` mode. Rows
    whose cap jumps between the two CDF summation orders are excluded, and
    named in the assertion; the kernel-level tests above and
    ``test_cap_rounding_is_the_only_difference`` feed identical CDFs."""
    grid, u, v = _make_case(19, rows=8, n=61, v_mass=1.9)
    weights = np.arange(1.0, 9.0, dtype=np.float32)  # non-uniform cotangent
    w_ref, g_ref = _jax_value_and_grad(monkeypatch, grid, u, v, lqr, mode, weights)
    w, g = _port_value_and_grad(grid, u, v, lqr, weights)
    same = _same_cap_rows(u, v, lqr)
    assert same.sum() >= 6, f"the cap jumps on rows {np.flatnonzero(~same)}"
    np.testing.assert_allclose(w[same], w_ref[same], rtol=3e-5)
    _assert_close(g[same], g_ref[same], 3e-5)


def test_cap_rounding_is_the_only_difference():
    """Fed the same CDFs, the port's W equals JAX's on every row, including
    rows the test above may exclude."""
    grid, u, v = _make_case(19, rows=8, n=61, v_mass=1.9)
    alpha, beta, gaug = _alpha_beta(grid, u, v, True)
    ref = np.asarray(jsot._sot_bilinear_xla(jnp.asarray(alpha), jnp.asarray(beta),
                                            jnp.asarray(gaug), 2.0))
    got = kmerge.sot_w2_merge(_t(alpha), _t(beta), _t(gaug)).numpy()
    np.testing.assert_allclose(got, ref, rtol=3e-5)


def test_gradient_at_attained_and_saturated_caps(monkeypatch):
    """Rows where the cap is attained by U (the target's CDF reaches exactly
    1.0), where alpha and beta both saturate at the cap over a run of bins,
    and where U and V tie at the cap: the port's autograd around the kernel
    (minimum / maximum / amax tie splits) must give JAX's gradient."""
    n = 16
    grid = np.linspace(0.0, 1.0, n).astype(np.float32)
    u = np.zeros((4, n), np.float32)
    v = np.zeros((4, n), np.float32)
    # row 0: U hits 1.0 at bin 7 and stays (saturated tail), V overshoots
    u[0, [2, 5, 7]] = [0.25, 0.25, 0.5]
    v[0, [3, 6, 9]] = [0.5, 0.5, 0.5]
    # row 1: U and V both reach 1.0 exactly (tie at the cap) and saturate
    u[1, [1, 4]] = [0.5, 0.5]
    v[1, [2, 4]] = [0.5, 0.5]
    # row 2: V under-shoots (mass 0.75): the cap is U's 1.0
    u[2, [0, 8]] = [0.5, 0.5]
    v[2, [3, 12]] = [0.5, 0.25]
    # row 3: V's partial sums hit 1.0 before U's end
    u[3, [5, 10, 15]] = [0.25, 0.25, 0.5]
    v[3, [0, 1, 2, 11]] = [0.25, 0.25, 0.5, 0.25]
    weights = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    for mode, lqr in (("", False), ("ref", True)):
        assert _same_cap_rows(u, v, lqr).all()  # dyadic weights: exact sums
        w_ref, g_ref = _jax_value_and_grad(monkeypatch, grid, u, v, lqr, mode, weights)
        w, g = _port_value_and_grad(grid, u, v, lqr, weights)
        np.testing.assert_allclose(w, w_ref, rtol=1e-6, atol=1e-7)
        _assert_close(g, g_ref, 2e-5)


@pytest.mark.parametrize("p,target_constant", [(3.0, True), (2.0, False)])
def test_plane_paths_p3_and_live_target_match_the_dense_form(p, target_constant):
    """The paths that raised before the banded-plane kernels (B6-B7) were
    ported now run: p = 3 through ``plane``, a live target through
    ``hybrid``, each equal to the dense O(n^2) form (W within 3e-5 of the
    marginal terms, as above)."""
    grid, u, v = _make_case(1, rows=2, n=8)
    w = tw.wasserstein_same_grid(_t(grid), _t(u), _t(v), p=p, target_constant=target_constant)
    alpha, beta, gaug = tw.clipped_cdfs(_t(grid), _t(u), _t(v))
    ref = kplane.sot_plane_forward_plain(alpha, beta, gaug, p).numpy()
    a, b, g = alpha.numpy(), beta.numpy(), gaug.numpy()
    marg = ((a - np.pad(a, ((0, 0), (1, 0)))[:, :-1]) @ np.abs(g) ** p
            + (b - np.pad(b, ((0, 0), (1, 0)))[:, :-1]) @ np.abs(g) ** p)
    np.testing.assert_allclose(w.numpy(), ref, atol=3e-5 * float(marg.max()), rtol=0)


@pytest.mark.parametrize("lqr", [False, True])
def test_p1_closed_form_matches(lqr):
    grid, u, v = _make_case(3, rows=6, n=50, v_mass=1.9)
    ref = np.asarray(jsot.wasserstein_same_grid(jnp.asarray(grid), jnp.asarray(u),
                                                jnp.asarray(v), p=1.0, limit_quantile_range=lqr))
    got = tw.wasserstein_same_grid(_t(grid), _t(u), _t(v), p=1.0,
                                   limit_quantile_range=lqr).numpy()
    same = _same_cap_rows(u, v, lqr)
    np.testing.assert_allclose(got[same], ref[same], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("lqr", [False, True])
def test_wasserstein_1d_general_path_matches(p, lqr):
    """The sorting path on unsorted, per-row positions: values and the
    gradient to both weights and positions."""
    rng = np.random.default_rng(p)
    rows, n, m = 4, 23, 31
    uv = rng.random((rows, n)).astype(np.float32)
    vv = rng.random((rows, m)).astype(np.float32)
    uw = rng.random((rows, n)).astype(np.float32)
    vw = rng.random((rows, m)).astype(np.float32)
    uw /= uw.sum(-1, keepdims=True)
    vw /= vw.sum(-1, keepdims=True) / 1.3

    def jloss(a, b, c, d):
        return jnp.sum(jw.wasserstein_1d(a, b, c, d, p=p, limit_quantile_range=lqr))

    ref_val = np.asarray(jw.wasserstein_1d(*(jnp.asarray(z) for z in (uv, vv, uw, vw)),
                                           p=p, limit_quantile_range=lqr))
    ref_g = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(z) for z in (uv, vv, uw, vw)))
    ts = [_t(z).requires_grad_(True) for z in (uv, vv, uw, vw)]
    got = tw.wasserstein_1d(*ts, p=p, limit_quantile_range=lqr)
    got.sum().backward()
    # with the cutoff, a row whose CDF passes 1.0 within an ulp drops a
    # different merged segment in the two summation orders: excluded
    same = np.ones(rows, bool)
    if lqr:
        for w in (uw[np.arange(rows)[:, None], np.argsort(uv, -1, kind="stable")],
                  vw[np.arange(rows)[:, None], np.argsort(vv, -1, kind="stable")]):
            same &= np.all((np.asarray(jnp.cumsum(jnp.asarray(w), -1)) > 1.0)
                           == (np.cumsum(w.astype(np.float64), -1).astype(np.float32) > 1.0), -1)
    assert same.sum() >= rows - 2, f"the cutoff moves on rows {np.flatnonzero(~same)}"
    np.testing.assert_allclose(got.detach().numpy()[same], ref_val[same], rtol=2e-5, atol=1e-7)
    for t, rg in zip(ts, ref_g):
        _assert_close(t.grad.numpy()[same], np.asarray(rg)[same], 2e-5)
    q_ref = jw.wasserstein_1d(*(jnp.asarray(z) for z in (uv, vv, uw, vw)), return_quantiles=True)
    q = tw.wasserstein_1d(*(_t(z) for z in (uv, vv, uw, vw)), return_quantiles=True)
    for a, b in zip(q, q_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-7)


def test_cpu_wrappers_launch_nothing():
    alpha, beta, gaug, wbar = _case_inputs("random", True, 1.9)
    before = (kmerge.launches, krefgrad.launches)
    kmerge.sot_w2_merge(_t(alpha), _t(beta), _t(gaug))
    krefgrad.ref_grad_beta(_t(alpha), _t(beta), _t(gaug), _t(wbar))
    assert (kmerge.launches, krefgrad.launches) == before


def test_wrappers_raise_on_non_cuda_devices():
    a = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="coupling"):
        kmerge.coupling(a, a, torch.empty((8,), device="meta"))
    with pytest.raises(ValueError, match="ref_grad_beta"):
        krefgrad.ref_grad_beta(a, a, torch.empty((8,), device="meta"),
                               torch.empty((4,), device="meta"))

