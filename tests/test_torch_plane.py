"""The banded-plane SOT kernels' plain versions (kernels 6 and 7) and the
same-grid routes of the port against ``sot_tpu.ops.pallas.sot``.

The JAX kernels run as the JAX package's own tests run them on the CPU
(``SOT_TPU_PALLAS_INTERPRET=1``). Gradients are compared UNMASKED, kinks
included (PERF.md, "The gradient-convention lesson").

Tolerances: on dyadic rows (``chip_smoke.dyadic_plane_rows``: every product
and sum exact in f32) bit for bit; otherwise W within 1e-5 of each row's
value (all terms >= 0; the JAX kernel sums in f32, the plain version in
float64) and cotangents within 2e-5 of their max (``tests/test_refgrad.py``'s
bound); through ``wasserstein_same_grid`` W within 3e-5 of the marginal
terms and the gradients within 3e-5 of their max (``tests/test_torch_sot.py``), on weights
whose CDF sums are exact, so that the quantile cap is the same in both.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from sot_tpu.kernel_gates import auto_gates  # noqa: E402
from sot_tpu.ops.pallas import sot as jsot  # noqa: E402
from sot_tpu_torch.kernel_gates import ADOPTION_DIR, KernelGates  # noqa: E402
from sot_tpu_torch.losses import Wasserstein1D  # noqa: E402
from sot_tpu_torch.ops import wasserstein as tw  # noqa: E402
from sot_tpu_torch.ops.kernels import plane as kplane  # noqa: E402
from test_torch_sot import _same_cap_rows  # noqa: E402

GATES = ("SOT_TPU_W2_MERGE", "SOT_TPU_W2_MERGE_SMALL", "SOT_TPU_MERGE_ROWS", "SOT_TPU_W2_SMALL_N")
# the SOT routes of the JAX package's committed gates (auto_gates() on
# results/round2): ref above 512 bins, hybrid at or below
JAX_AUTO = KernelGates(w2_merge="ref", w2_merge_small="hybrid")


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SOT_TPU_PALLAS_INTERPRET", "1")
    for k in GATES:
        monkeypatch.delenv(k, raising=False)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _grid(kind: str, n: int) -> np.ndarray:
    """A uniform grid, or the log-mapped one of SOT-512-LogF's kind."""
    hz = np.linspace(0.0, 8000.0, n)
    if kind == "uniform":
        return (hz / hz.max()).astype(np.float32)
    midi = np.where(hz > 0, 12 * np.log2(np.maximum(hz, 1e-9) / 440.0) + 69, 0.0)
    lo, hi = 12 * np.log2(32.7 / 440.0) + 69, 12 * np.log2(7902.0 / 440.0) + 69
    return np.sort((midi - lo) / (hi - lo)).astype(np.float32)


def _rows(grid_kind: str, rows=16, n=40, seed=0):
    """Real-valued clipped CDFs on the chosen grid, with a row weight."""
    alpha, beta, _, wbar = chip_smoke.random_plane_rows(np.random.default_rng(seed), rows, n)
    g = _grid(grid_kind, n - 1)
    return alpha, beta, np.concatenate([g, g[-1:]]), wbar


def _jax_bwd_both(alpha, beta, g, p, wbar):
    return [np.asarray(t) for t in jsot._pallas_bwd(*(jnp.asarray(a) for a in (alpha, beta, g)),
                                                    p, jnp.asarray(wbar), alpha_grads=True)]


def _jax_xla_grads(alpha, beta, g, p, wbar):
    def loss(a, b):
        return jnp.sum(jsot._sot_bilinear_xla(a, b, jnp.asarray(g), p) * jnp.asarray(wbar))

    return [np.asarray(t) for t in jax.grad(loss, argnums=(0, 1))(jnp.asarray(alpha),
                                                                   jnp.asarray(beta))]


def _assert_close(got, want, tol):
    scale = float(np.max(np.abs(want))) + 1e-12
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol * scale, rtol=0)


@pytest.mark.parametrize("p", [2.0, 3.0])
@pytest.mark.parametrize("grid_kind", ["uniform", "log"])
def test_plane_plain_versions_match_jax(p, grid_kind):
    """Forward against ``_pallas_fwd`` and ``_sot_bilinear_xla``; backward,
    both ``alpha_grads``, against ``_pallas_bwd`` and ``jax.grad`` of
    ``_sot_bilinear_xla`` (the plane convention: lax.min/max halve at ties)."""
    alpha, beta, g, wbar = _rows(grid_kind)
    ja, jb, jg = (jnp.asarray(a) for a in (alpha, beta, g))
    w = kplane.sot_plane_forward(_t(alpha), _t(beta), _t(g), p).numpy()
    for ref in (jsot._pallas_fwd(ja, jb, jg, p), jsot._sot_bilinear_xla(ja, jb, jg, p)):
        np.testing.assert_allclose(w, np.asarray(ref), rtol=1e-5, atol=0)

    da, db = kplane.sot_plane_backward(_t(alpha), _t(beta), _t(g), p, _t(wbar), True)
    none, db_tc = kplane.sot_plane_backward(_t(alpha), _t(beta), _t(g), p, _t(wbar), False)
    assert none is None and torch.equal(db, db_tc)
    for ref_a, ref_b in (_jax_bwd_both(alpha, beta, g, p, wbar),
                         _jax_xla_grads(alpha, beta, g, p, wbar)):
        _assert_close(da.numpy(), ref_a, 2e-5)
        _assert_close(db.numpy(), ref_b, 2e-5)


@pytest.mark.parametrize("p", [2.0, 3.0])
def test_plane_plain_versions_bit_equal_to_jax_on_dyadic_rows(p):
    """Ties, plateaus, empty intervals and a cap tail, every sum exact: the
    plain versions equal the JAX kernels and ``jax.grad`` of the XLA form
    bit for bit, so the tie convention is held apart from rounding."""
    alpha, beta, g, wbar = chip_smoke.dyadic_plane_rows(np.random.default_rng(1), 24, 40)
    ja, jb, jg = (jnp.asarray(a) for a in (alpha, beta, g))
    w = kplane.sot_plane_forward_plain(_t(alpha), _t(beta), _t(g), p).numpy()
    np.testing.assert_array_equal(w, np.asarray(jsot._pallas_fwd(ja, jb, jg, p)))
    np.testing.assert_array_equal(w, np.asarray(jsot._sot_bilinear_xla(ja, jb, jg, p)))
    da, db = kplane.sot_plane_backward_plain(_t(alpha), _t(beta), _t(g), p, _t(wbar), True)
    _, db_tc = kplane.sot_plane_backward_plain(_t(alpha), _t(beta), _t(g), p, _t(wbar), False)
    ref_a, ref_b = _jax_bwd_both(alpha, beta, g, p, wbar)
    np.testing.assert_array_equal(da.numpy(), ref_a)
    np.testing.assert_array_equal(db.numpy(), ref_b)
    np.testing.assert_array_equal(db_tc.numpy(), ref_b)
    xa, xb = _jax_xla_grads(alpha, beta, g, p, wbar)
    np.testing.assert_array_equal(da.numpy(), xa)
    np.testing.assert_array_equal(db.numpy(), xb)
    assert np.count_nonzero(db.numpy()) > 0 and np.any(alpha == beta)


def test_plane_plain_chunks_agree_with_one_chunk(monkeypatch):
    """The row chunking of the plain versions changes no value."""
    alpha, beta, g, wbar = (_t(a) for a in _rows("uniform", rows=9, n=33))
    whole = (kplane.sot_plane_forward_plain(alpha, beta, g, 2.0),
             *kplane.sot_plane_backward_plain(alpha, beta, g, 2.0, wbar, True))
    monkeypatch.setattr(kplane, "_CHUNK_CELLS", 2 * 33 * 33)
    assert len(kplane._row_chunks(9, 33)) == 5
    chunked = (kplane.sot_plane_forward_plain(alpha, beta, g, 2.0),
               *kplane.sot_plane_backward_plain(alpha, beta, g, 2.0, wbar, True))
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_bins", [257, 1025])
def test_w2_route_follows_the_jax_gates(monkeypatch, n_bins):
    """JAX_AUTO is JAX's ``_merge_mode`` under its committed gates
    (``auto_gates()`` on ``results/round2``), the port's ``auto`` JAX's mode
    under JAX's rule on the port's adoption files, ``default`` its mode with
    no gate set ("off": the plane kernels)."""
    for k, v in auto_gates().items():
        monkeypatch.setenv(k, v)
    assert tw.w2_route(n_bins, JAX_AUTO) == jsot._merge_mode(n_bins)
    for k in GATES:
        monkeypatch.delenv(k, raising=False)
    for k, v in auto_gates(ADOPTION_DIR).items():
        monkeypatch.setenv(k, v)
    mode = jsot._merge_mode(n_bins)
    assert tw.w2_route(n_bins, "auto") == ("plane" if mode == "off" else mode)
    for k in GATES:
        monkeypatch.delenv(k, raising=False)
    assert jsot._merge_mode(n_bins) == "off"
    assert tw.w2_route(n_bins, "default") == "plane"
    with pytest.raises(ValueError, match="kernels"):
        tw.w2_route(n_bins, "fast")


def _spectra(rows, n, seed):
    """Spectra-like weight rows on a 2^-12 lattice (zero bins, u's mass
    about 1, v's about 1.2): every CDF sum is exact in both packages'
    summation orders, so the quantile cap is the same value in both."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(0.0, 1.0, n, dtype=np.float32)
    u = np.floor(rng.random((rows, n)) ** 4 * 4096 * 5 / n)
    v = np.floor(rng.random((rows, n)) ** 4 * 4096 * 6 / n)
    u[:, ::7] = 0.0
    v[:, ::5] = 0.0
    return grid, (u / 4096).astype(np.float32), (v / 4096).astype(np.float32)


# (port kernels, JAX gates, JAX use_pallas, p): each port route and the JAX
# route that computes the same function on the CPU
ROUTES = {
    "ref": (JAX_AUTO, {"SOT_TPU_W2_MERGE": "ref"}, None, 2.0),
    "hybrid": (JAX_AUTO, {"SOT_TPU_W2_MERGE": "ref", "SOT_TPU_W2_MERGE_SMALL": "hybrid"}, None,
               2.0),
    "plane": ("default", {}, True, 2.0),
    "plane p=3": (JAX_AUTO, {"SOT_TPU_W2_MERGE": "ref", "SOT_TPU_W2_MERGE_SMALL": "hybrid"}, True,
                  3.0),
}


@pytest.mark.parametrize("target_constant", [True, False])
@pytest.mark.parametrize("route", list(ROUTES))
def test_wasserstein_same_grid_routes_match_jax(monkeypatch, route, target_constant):
    """Values and the u and v gradients through every route, 256 rows where
    JAX groups the rows by their half-mass bin for its 128-row blocks (the
    port does not, and must still agree)."""
    kernels, gates, use_pallas, p = ROUTES[route]
    # JAX groups rows from 256 on; its ``ref`` route with a constant target
    # never groups, and its interpret-mode refgrad is slow: 128 rows there
    rows, n = (128 if route == "ref" and target_constant else 256), 40
    grid, u, v = _spectra(rows, n, seed=3)
    weights = np.random.default_rng(4).uniform(0.5, 1.5, rows).astype(np.float32)
    for k, val in gates.items():
        monkeypatch.setenv(k, val)
    if route == "ref":
        # JAX_AUTO sends rows this narrow to ``hybrid``: lower its
        # threshold, as JAX without ``SOT_TPU_W2_MERGE_SMALL`` has none
        assert tw.w2_route(n, JAX_AUTO) == "hybrid"
        monkeypatch.setattr(tw, "SMALL_N", 16)
    assert jsot._merge_mode(n) == {"ref": "ref", "hybrid": "hybrid", "plane": "off",
                                   "plane p=3": "hybrid"}[route]

    def jloss(uu, vv):
        w = jsot.wasserstein_same_grid(jnp.asarray(grid), uu, vv, p=p, limit_quantile_range=True,
                                       use_pallas=use_pallas, target_constant=target_constant)
        return jnp.sum(w * jnp.asarray(weights)), w

    (_, w_ref), (gu_ref, gv_ref) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(u), jnp.asarray(v))
    ut, vt = _t(u).requires_grad_(True), _t(v).requires_grad_(True)
    w = tw.wasserstein_same_grid(_t(grid), ut, vt, p=p, limit_quantile_range=True,
                                 target_constant=target_constant, kernels=kernels)
    torch.sum(w * _t(weights)).backward()

    assert _same_cap_rows(u, v, True).all()
    # W = marginals - 2 x coupling on the merge routes: its error is
    # relative to the marginal terms it is computed from
    alpha, beta, gaug = (t.numpy() for t in tw.clipped_cdfs(_t(grid), _t(u), _t(v), True))
    gp = np.abs(gaug) ** p
    marg = ((alpha - np.pad(alpha, ((0, 0), (1, 0)))[:, :-1]) @ gp
            + (beta - np.pad(beta, ((0, 0), (1, 0)))[:, :-1]) @ gp)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_ref),
                               atol=3e-5 * float(marg.max()), rtol=0)
    _assert_close(vt.grad.numpy(), np.asarray(gv_ref), 3e-5)
    if target_constant:
        assert ut.grad is None and not np.any(np.asarray(gu_ref))
    else:
        _assert_close(ut.grad.numpy(), np.asarray(gu_ref), 3e-5)


def test_skill_golden_through_the_default_wasserstein1d():
    """The repository's SOT golden check (0.064275, the JAX package's
    verification recipe): 3-harmonic tones (``oscillator_bank``, amplitudes
    0.5, 4096 samples at 16 kHz) at 220 and 210 Hz, flattop 2048/256 spectra
    on rfftfreq/max positions, ``Wasserstein1D(p=2, square_dist, dont_normalize,
    limit_quantile_range)`` on JAX_AUTO with a live target (the ``ref``
    route turned ``hybrid``), and on the port's ``auto``. On the JAX package's spectra the port's loss is 0.064275
    within 1e-7 (the torch oracle's 0.06427490); the port's own synthesis
    sums its phases in float64, not in f32, which moves the spectra by
    ~4e-5 and the loss to ~0.0642871: there both packages' losses agree
    within 1e-6. The self-loss is 0 and the target gets a gradient."""
    from sot_tpu.losses import Wasserstein1D as JaxWasserstein1D
    from sot_tpu.ops import oscillator_bank as jax_oscillator_bank
    from sot_tpu.ops.stft import stft_magnitude as jax_stft_magnitude

    from sot_tpu_torch.ops.oscillator import oscillator_bank
    from sot_tpu_torch.ops.stft import rfft_frequencies, stft_magnitude

    def jax_spec(f0):
        audio = jax_oscillator_bank(jnp.full((1, 4096, 3), f0) * jnp.asarray([1.0, 2.0, 3.0]),
                                    jnp.full((1, 4096, 3), 0.5), sample_rate=16000)
        return _t(jax_stft_magnitude(audio, size=2048, overlap=1 - 256 / 2048, window="flattop"))

    def port_spec(f0):
        audio = oscillator_bank(torch.full((1, 4096, 3), f0) * torch.tensor([1.0, 2.0, 3.0]),
                                torch.full((1, 4096, 3), 0.5), sample_rate=16000)
        return stft_magnitude(audio, size=2048, overlap=1 - 256 / 2048, window="flattop")

    pos = rfft_frequencies(2048, 16000)
    pos = (pos / pos.max()).astype(np.float32)
    kw = dict(p=2, square_dist=True, dont_normalize=True, limit_quantile_range=True)
    fn, jfn = Wasserstein1D(**kw, kernels=JAX_AUTO), JaxWasserstein1D(**kw)
    assert not fn.target_constant and tw.w2_route(len(pos), JAX_AUTO) == "ref"

    sa, sb = jax_spec(220.0).requires_grad_(True), jax_spec(210.0).requires_grad_(True)
    auto = float(Wasserstein1D(**kw)(sa, sb, x_pos=pos, y_pos=pos).detach())
    assert abs(auto - 0.0642749) <= 1e-7, auto
    loss = fn(sa, sb, x_pos=pos, y_pos=pos)
    assert abs(float(loss.detach()) - 0.0642749) <= 1e-7, float(loss.detach())
    loss.backward()
    assert bool(torch.isfinite(sa.grad).all() and torch.isfinite(sb.grad).all())
    assert float(sa.grad.abs().max()) > 0.0
    assert float(fn(sa, sa, x_pos=pos, y_pos=pos).detach()) <= 4e-12

    pa, pb = port_spec(220.0), port_spec(210.0)
    ref = float(jfn(jnp.asarray(pa.numpy()), jnp.asarray(pb.numpy()), x_pos=pos, y_pos=pos))
    np.testing.assert_allclose(float(fn(pa, pb, x_pos=pos, y_pos=pos)), ref, rtol=1e-6)


def test_p_and_target_paths_no_longer_raise():
    """Every p >= 1 and both target kinds have a route."""
    grid, u, v = _spectra(4, 12, seed=5)
    for p in (1.0, 1.5, 2.0, 3.0):
        for tc in (True, False):
            for kernels in ("auto", "default"):
                w = tw.wasserstein_same_grid(_t(grid), _t(u), _t(v), p=p, target_constant=tc,
                                             kernels=kernels)
                assert w.shape == (4,) and bool(torch.isfinite(w).all())
    with pytest.raises(ValueError, match="p>=1"):
        tw.wasserstein_same_grid(_t(grid), _t(u), _t(v), p=0.5)
