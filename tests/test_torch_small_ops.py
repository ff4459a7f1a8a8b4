"""The port's remaining library ops against the JAX package's, on the CPU,
with numpy-seeded inputs: ``angular_cumsum`` and ``oscillator_bank(
use_angular_cumsum=True)``, bicubic and nearest ``resample``,
``stft_magnitude(center=True)``, ``log10`` / ``power_to_db``, the A-curve
and the loudness functions, ``get_transform``, the four extra losses and
``Sinusoidal`` with each amplitude resample method and the angular flag.

Tolerances, each with its reason:
  * ``angular_cumsum``: sin of the phase within 1e-3 of JAX's and of a
    float64 cumsum mod 2pi (the JAX package's own test limit; the port sums
    each chunk in float64, JAX in f32: ~5e-5 measured), the phase in
    [0, 2pi)
  * oscillator bank and ``Sinusoidal`` audio: atol 2e-3 (phases of ~1e3
    rad summed in other orders; 7e-4 measured at 4096 samples, 8 sinusoids)
  * bicubic: atol 1e-6 (one f32 matmul against an f32 einsum); nearest:
    equal (a gather at the same indices)
  * ``stft_magnitude(center=True)``: max|d| <= 1e-5 * max|ref| (two FFT
    libraries); its VJP the same
  * ``power_to_db``, loudness: atol 1e-5 dB / 1e-6 normalised (a log of
    the same f32 power; ~1e-7 measured); the A-curve: equal (the same
    float64 numpy expression)
  * the losses: values rtol 1e-5, gradients max|d| <= 2e-5 * max|ref|
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu import features as jfeatures  # noqa: E402
from sot_tpu import losses as jlosses  # noqa: E402
from sot_tpu.models import synths as jsynths  # noqa: E402
from sot_tpu_torch import features as tfeatures  # noqa: E402
from sot_tpu_torch import losses as tlosses  # noqa: E402
from sot_tpu_torch.models import synths as tsynths  # noqa: E402
from sot_tpu_torch.ops import numerics as tnum  # noqa: E402
from sot_tpu_torch.ops import oscillator as tosc  # noqa: E402
from sot_tpu_torch.ops import resample as tres  # noqa: E402
from sot_tpu_torch.ops import stft as tstft  # noqa: E402
from sot_tpu_torch.ops.kernels import synth as ksynth  # noqa: E402
from tests._torch_parity import rel_max_err  # noqa: E402

# ``sot_tpu.ops`` re-exports functions under its modules' names
josc, jres, jstft, jnum = (importlib.import_module(f"sot_tpu.ops.{m}")
                           for m in ("oscillator", "resample", "stft", "numerics"))

TWO_PI = 2.0 * np.pi


@pytest.fixture(autouse=True)
def _no_gates(monkeypatch):
    for k in ("SOT_TPU_SYNTH_PALLAS", "SOT_TPU_STFT_PALLAS", "SOT_TPU_W2_MERGE",
              "SOT_TPU_W2_MERGE_SMALL", "SOT_TPU_FORCE_GENERAL", "SOT_TPU_DFT_MATMUL"):
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------------
# angular_cumsum and the oscillator bank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_time,chunk", [(4096, 1000), (2500, 1000), (4096, 512), (700, 1000)])
def test_angular_cumsum_matches_jax(n_time, chunk):
    omega = np.random.default_rng(0).uniform(0, 0.5, (2, n_time, 3)).astype(np.float32)
    ref = np.asarray(josc.angular_cumsum(jnp.asarray(omega), chunk_size=chunk))
    got = tosc.angular_cumsum(torch.from_numpy(omega), chunk_size=chunk).numpy()
    exact = np.cumsum(omega.astype(np.float64), axis=1) % TWO_PI
    assert got.shape == ref.shape == omega.shape
    assert np.abs(np.sin(got) - np.sin(ref)).max() <= 1e-3
    assert np.abs(np.sin(got) - np.sin(exact)).max() <= 1e-3
    assert np.abs(np.cos(got) - np.cos(exact)).max() <= 1e-3
    assert got.min() >= 0.0 and got.max() < TWO_PI


@pytest.mark.parametrize("angular", [False, True])
def test_oscillator_bank_angular_matches_jax(angular):
    rng = np.random.default_rng(1)
    freqs = rng.uniform(40, 2000, (2, 2048, 4)).astype(np.float32)
    amps = rng.uniform(0, 1, (2, 2048, 4)).astype(np.float32)
    ref = np.asarray(josc.oscillator_bank(jnp.asarray(freqs), jnp.asarray(amps),
                                          use_angular_cumsum=angular))
    got = tosc.oscillator_bank(torch.from_numpy(freqs), torch.from_numpy(amps),
                               use_angular_cumsum=angular).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)
    plain = tosc.oscillator_bank(torch.from_numpy(freqs), torch.from_numpy(amps)).numpy()
    np.testing.assert_allclose(got, plain, atol=2e-3)


# ---------------------------------------------------------------------------
# bicubic and nearest resampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,n_out,add_endpoint", [
    ((2, 16, 4), 4096, True), ((2, 16, 4), 4096, False), ((1, 8, 2), 64, False),
    ((2, 64, 3), 24, True), ((2, 64, 3), 24, False), ((1, 1, 2), 16, False)])
@pytest.mark.parametrize("method", ["bicubic", "nearest"])
def test_resample_matches_jax(method, shape, n_out, add_endpoint):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jres.resample(jnp.asarray(x), n_out, method=method,
                                   add_endpoint=add_endpoint))
    got = tres.resample(torch.from_numpy(x), n_out, method=method,
                        add_endpoint=add_endpoint).numpy()
    assert got.shape == ref.shape
    if method == "nearest":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("align_corners", [False, True])
def test_bicubic_matches_torch_interpolate(align_corners):
    x = np.random.default_rng(6).standard_normal((2, 16, 3)).astype(np.float32)
    got = tres.resample(torch.from_numpy(x), 256, method="bicubic",
                        add_endpoint=not align_corners).numpy()
    xt = torch.from_numpy(x).permute(0, 2, 1)[:, :, :, None]
    ref = torch.nn.functional.interpolate(xt, size=[256, 1], mode="bicubic",
                                          align_corners=align_corners)[:, :, :, 0]
    np.testing.assert_allclose(got, ref.permute(0, 2, 1).numpy(), atol=1e-5)


def test_resample_ranks():
    x = torch.linspace(0.0, 1.0, 16)
    for method in ("bicubic", "nearest"):
        assert tres.resample(x, 64, method=method).shape == (64,)
        assert tres.resample(x[None], 64, method=method).shape == (1, 64)


# ---------------------------------------------------------------------------
# stft_magnitude(center=True)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad_end", [False, True])
@pytest.mark.parametrize("size,hop,window,normalized", [(1024, 256, "ones", False),
                                                        (512, 64, None, True)])
def test_stft_center_matches_jax(pad_end, size, hop, window, normalized):
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.9, 0.9, (2, 4000)).astype(np.float32)
    kw = dict(size=size, overlap=1.0 - hop / size, window=window, normalized=normalized,
              center=True, pad_end=pad_end)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tstft.stft_magnitude(xt, **kw)
    ct = rng.standard_normal(tuple(got.shape)).astype(np.float32)
    got.backward(torch.from_numpy(ct))

    @jax.jit
    def value_and_vjp(a, c):
        y, vjp = jax.vjp(lambda b: jstft.stft_magnitude(b, **kw), a)
        return y, vjp(c)[0]

    ref, ref_grad = value_and_vjp(jnp.asarray(x), jnp.asarray(ct))
    assert got.shape == ref.shape
    assert rel_max_err(got.detach().numpy(), np.asarray(ref)) <= 1e-5
    assert rel_max_err(xt.grad.numpy(), np.asarray(ref_grad)) <= 1e-5


def test_stft_center_matches_torch_stft():
    x = np.random.default_rng(4).uniform(-1, 1, (3, 4096)).astype(np.float32)
    got = tstft.stft_magnitude(torch.from_numpy(x), size=1024, overlap=0.75, window="ones",
                               normalized=False, center=True, pad_end=False).numpy()
    ref = torch.stft(torch.from_numpy(x), n_fft=1024, hop_length=256,
                     window=torch.ones(1024), center=True, pad_mode="reflect",
                     return_complex=True).abs().permute(0, 2, 1).numpy()
    assert rel_max_err(got, ref) <= 1e-5


# ---------------------------------------------------------------------------
# numerics and loudness
# ---------------------------------------------------------------------------


def _powers():
    rng = np.random.default_rng(7)
    return np.concatenate([[0.0, 1e-30, 1e-9, 1e-8, 0.1, 1.0, 1e4],
                           rng.uniform(0, 3, 40)]).astype(np.float32)


@pytest.mark.parametrize("ref_db,range_db", [(0.0, 80.0), (20.0, 60.0), (-3.0, 120.0)])
def test_power_to_db_matches_jax(ref_db, range_db):
    p = _powers()
    ref = np.asarray(jnum.power_to_db(jnp.asarray(p), ref_db=ref_db, range_db=range_db))
    got = tnum.power_to_db(torch.from_numpy(p), ref_db=ref_db, range_db=range_db).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert got.min() >= -range_db


def test_log10_matches_jax():
    p = _powers()
    np.testing.assert_allclose(tnum.log10(torch.from_numpy(p)).numpy(),
                               np.asarray(jnum.log10(jnp.asarray(p))), atol=1e-6, rtol=0)


def test_a_weighting_db_equals_jax():
    for n_fft in (512, 1024, 2048):
        freqs = np.fft.rfftfreq(n_fft, 1.0 / 16000)
        got = tfeatures.a_weighting_db(freqs)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jfeatures.a_weighting_db(freqs))
    # the standard's table: 0 dB at 1 kHz, -19.1 dB at 100 Hz, -50.5 dB at 20 Hz
    w = tfeatures.a_weighting_db(np.array([1000.0, 100.0, 20.0]))
    assert abs(w[0]) < 0.02 and abs(w[1] + 19.1) < 0.2 and abs(w[2] + 50.5) < 0.5


@pytest.mark.parametrize("n_fft,hop", [(1024, 64), (512, 128)])
def test_loudness_matches_jax(n_fft, hop):
    x = np.random.default_rng(8).uniform(-0.9, 0.9, (3, 4096)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jfeatures.a_weighting_from_audio(a, n_fft, hop))(
        jnp.asarray(x)))
    got = tfeatures.a_weighting_from_audio(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    ref1 = np.asarray(jax.jit(lambda a: jfeatures.get_loudness(a, hop, n_fft))(
        jnp.asarray(x[0])))
    got1 = tfeatures.get_loudness(torch.from_numpy(x[0]), hop, n_fft).numpy()
    assert got1.shape == ref1.shape
    np.testing.assert_allclose(got1, ref1, atol=1e-6, rtol=0)


def test_loudness_weighting_argument():
    x = np.random.default_rng(9).uniform(-0.9, 0.9, (2, 2048)).astype(np.float32)
    w = np.random.default_rng(10).uniform(0.1, 1.0, 513).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a, b: jfeatures.get_loudness(a, 256, weighting=b))(
        jnp.asarray(x), jnp.asarray(w)))
    got = tfeatures.get_loudness(torch.from_numpy(x), 256, weighting=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# get_transform
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    {"type": "stft", "n_fft": 2048, "hop_length": 256, "window": "flattop"},
    {"type": "stft", "n_fft": 512, "hop_length": 128, "center": True, "pad_mode": "reflect"},
    {"type": "cqt", "fmin": 32.7, "bins_per_semitone": 3, "n_bins": "auto"},
    {"type": "cqt", "fmin": 65.4, "bins_per_semitone": 1, "n_bins": 60, "log": True},
    "stft", "cqt", "identity", None])
def test_get_transform_matches_jax(spec):
    ref = jfeatures.get_transform(spec, 16000)
    got = tfeatures.get_transform(spec, 16000)
    assert type(got).__name__ == type(ref).__name__
    for field in ("n_fft", "hop_length", "sample_rate", "window", "log", "fmin",
                  "bins_per_semitone", "n_bins"):
        assert getattr(got, field, None) == getattr(ref, field, None), field
    freqs = ref.get_frequencies()
    if freqs is None:
        assert got.get_frequencies() is None
    else:
        np.testing.assert_array_equal(got.get_frequencies(), freqs)
    if type(got).__name__ == "STFT":
        x = np.random.default_rng(11).uniform(-1, 1, (2, 4096)).astype(np.float32)
        assert rel_max_err(got(torch.from_numpy(x)).numpy(),
                           np.asarray(ref(jnp.asarray(x)))) <= 1e-5


def test_get_transform_unknown_raises():
    with pytest.raises(ValueError, match="Unknown transform"):
        tfeatures.get_transform("mel", 16000)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------


def _grad_jax(fn, *args):
    val, g = jax.jit(jax.value_and_grad(lambda last: fn(*args[:-1], last)))(
        jnp.asarray(args[-1]))
    return float(val), np.asarray(g)


def _grad_port(fn, *args):
    last = torch.from_numpy(np.array(args[-1])).requires_grad_(True)
    val = fn(*(torch.from_numpy(np.array(a)) for a in args[:-1]), last)
    val.backward()
    return float(val.detach()), last.grad.numpy()


def _check(jfn, tfn, *args):
    jv, jg = _grad_jax(jfn, *[jnp.asarray(a) for a in args])
    tv, tg = _grad_port(tfn, *args)
    assert tv == pytest.approx(jv, rel=1e-5)
    assert rel_max_err(tg, jg) <= 2e-5


@pytest.mark.parametrize("loss_type", ["L1", "L2"])
@pytest.mark.parametrize("sort,weighted", [(False, False), (True, False), (False, True)])
def test_mean_difference_matches_jax(loss_type, sort, weighted):
    rng = np.random.default_rng(12)
    x, y = (rng.standard_normal((4, 9, 33)).astype(np.float32) for _ in range(2))
    w = rng.uniform(0, 2, (33,)).astype(np.float32) if weighted else None
    jl, tl = jlosses.MeanDifference(loss_type), tlosses.MeanDifference(loss_type)
    kw_j = {"sort": sort, "weights": None if w is None else jnp.asarray(w)}
    kw_t = {"sort": sort, "weights": None if w is None else torch.from_numpy(w)}
    _check(lambda a, b: jl(a, b, **kw_j), lambda a, b: tl(a, b, **kw_t), x, y)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(6, 65), (2, 5, 65)])
def test_kl_matches_jax(reverse, shape):
    rng = np.random.default_rng(13)
    x, y = (rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2))
    x[..., :4] = 0.0  # zero bins: the eps inside the logs
    _check(jlosses.KL(reverse=reverse), tlosses.KL(reverse=reverse), x, y)


@pytest.mark.parametrize("window,square_dist,dont_normalize", [
    (None, True, True), ("flattop", True, True), ("flattop", False, False)])
def test_wasserstein_with_transform_matches_jax(window, square_dist, dont_normalize):
    """The composition (its STFT, positions and keyword handling); cases
    whose rows keep clear of the SOT route's rounding-level
    discontinuities (a quantile cap or a near-flat CDF stretch, which
    ``tests/test_torch_losses.py`` handles row by row)."""
    rng = np.random.default_rng(14)
    x, y = (rng.uniform(-0.9, 0.9, (2, 2048)).astype(np.float32) for _ in range(2))
    w_kw = dict(p=2, square_dist=square_dist, dont_normalize=dont_normalize)
    jl = jlosses.Wasserstein1DWithTransform(jlosses.Wasserstein1D(**w_kw), window=window)
    tl = tlosses.Wasserstein1DWithTransform(tlosses.Wasserstein1D(**w_kw), window=window)
    _check(jl, tl, x, y)


def test_mix_of_losses_matches_jax():
    rng = np.random.default_rng(15)
    x, y = (rng.uniform(-0.9, 0.9, (2, 2048)).astype(np.float32) for _ in range(2))
    jmix = jlosses.MixOfLosses(
        losses=(jlosses.MSSLoss(fft_sizes=(512, 256)), jlosses.MeanDifference("L2")),
        weights=(0.05, 2.0))
    tmix = tlosses.MixOfLosses(
        losses=(tlosses.MSSLoss(fft_sizes=(512, 256)), tlosses.MeanDifference("L2")),
        weights=(0.05, 2.0))
    ref = jmix(jnp.asarray(x), jnp.asarray(y))
    got = tmix(torch.from_numpy(x), torch.from_numpy(y))
    assert list(got) == list(ref) == ["MSSLoss", "MeanDifference"]
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-5)


# ---------------------------------------------------------------------------
# Sinusoidal: amp_resample_method and use_angular_cumsum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angular", [False, True])
@pytest.mark.parametrize("method", ["window", "bilinear", "bicubic", "nearest"])
def test_sinusoidal_matches_jax(method, angular):
    rng = np.random.default_rng(16)
    amps = rng.uniform(0, 1, (2, 16, 8)).astype(np.float32)
    freqs = (rng.uniform(40, 400, (2, 16, 1)) * np.arange(1, 9)).astype(np.float32)
    kw = dict(n_samples=4096, amp_scale_fn=None, freq_scale_fn=None,
              amp_resample_method=method, use_angular_cumsum=angular)
    ref = np.asarray(jsynths.Sinusoidal(**kw)(jnp.asarray(amps), jnp.asarray(freqs)))
    before = ksynth.launches
    got = tsynths.Sinusoidal(**kw)(torch.from_numpy(amps), torch.from_numpy(freqs)).numpy()
    assert ksynth.launches == before  # a CPU tensor never launches the kernel
    assert got.shape == ref.shape == (2, 4096)
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_sinusoidal_routes_like_jax(monkeypatch):
    """``synth_render`` (kernel 2's wrapper) takes exactly the settings
    the JAX package's ``_use_fused_synth`` sends to its fused kernel:
    method ``window`` without the angular cumsum."""
    calls = []
    real = tsynths.synth_render
    monkeypatch.setattr(tsynths, "synth_render", lambda *a: calls.append(1) or real(*a))
    amps = torch.rand(1, 16, 4, generator=torch.Generator().manual_seed(0))
    freqs = 100.0 * torch.arange(1, 5, dtype=torch.float32).expand(1, 16, 4)
    for method in ("window", "bilinear", "bicubic", "nearest"):
        for angular in (False, True):
            calls.clear()
            tsynths.Sinusoidal(n_samples=1024, amp_scale_fn=None, freq_scale_fn=None,
                               amp_resample_method=method,
                               use_angular_cumsum=angular)(amps, freqs)
            assert len(calls) == (method == "window" and not angular), (method, angular)
    defaults = tsynths.Sinusoidal()
    assert (defaults.amp_resample_method, defaults.use_angular_cumsum) == ("window", False)
