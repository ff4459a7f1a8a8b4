"""The port's evaluation metrics against ``sot_tpu.metrics`` on the same
numpy-seeded audio and pitches.

Tolerances: spectral metrics within 1e-5 relative (f32 FFTs of two
frameworks and sums in another order; ``tests/test_torch_stft.py``'s level);
W1/W2 within 1e-5 relative (the sorting path, ``tests/test_torch_sot.py``);
the pitch metrics are counts of frames against a threshold, so they must be
equal on pitches chosen away from the thresholds, and within one frame on
random ones.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu import metrics as jm  # noqa: E402
from sot_tpu_torch import metrics as tm  # noqa: E402

ALL_METRICS = ("mse", "log_spectral_distance", "mss", "pitch_mse", "raw_pitch_accuracy",
               "raw_chroma_accuracy", "octave_difference", "1-wasserstein", "2-wasserstein")


def _audio(batch=3, seed=0):
    """A harmonic clip and a detuned, noisier estimate of it."""
    rng = np.random.default_rng(seed)
    t = np.arange(4096) / 16000.0
    f0 = rng.uniform(80, 800, (batch, 1))
    x = np.sin(2 * np.pi * f0 * t) + 0.4 * np.sin(4 * np.pi * f0 * t)
    x_hat = 0.8 * np.sin(2 * np.pi * 1.03 * f0 * t) + 0.05 * rng.standard_normal((batch, 4096))
    return x.astype(np.float32), x_hat.astype(np.float32)


def _pitches(batch=4, frames=16, seed=1):
    """Predicted and true pitch [batch, frames, 1]: right, an octave off,
    a fifth off or a few cents off, each well away from the 50-cent
    tolerance and the octave-fold boundaries."""
    rng = np.random.default_rng(seed)
    true = rng.uniform(50, 1500, (batch, 1, 1)) * np.ones((1, frames, 1))
    ratio = rng.choice([1.0, 2.0, 0.5, 1.5, 2 ** (10 / 1200), 2 ** (-20 / 1200), 4.0, 0.25],
                       (batch, frames, 1))
    return (true * ratio).astype(np.float32), true.astype(np.float32)


def _close(got, ref, rtol):
    np.testing.assert_allclose(float(got), float(ref), rtol=rtol, atol=1e-7)


def test_audio_metrics_match_jax():
    x, x_hat = _audio()
    kw = dict(fft_sizes=[2048, 512, 64], mag_weight=1.0, logmag_weight=0.5,
              log_spectral_distance_weight=0.25, loss_type="L1")

    def suite(m, a, b):
        return [m.mse(a, b), m.mse(a, b, sort=True), m.log_spectral_distance(a, b),
                m.ms_spectral_distance(a, b, **kw), m.wasserstein_distance(a, b, p=1),
                m.wasserstein_distance(a, b, p=2)]

    # jit: one compiled program instead of many eager dispatches
    ref = jax.jit(lambda a, b: suite(jm, a, b))(jnp.asarray(x), jnp.asarray(x_hat))
    for got, want in zip(suite(tm, torch.from_numpy(x), torch.from_numpy(x_hat)), ref):
        _close(got, want, 1e-5)


def test_pitch_metrics_match_jax():
    pred, true = _pitches()
    tp, tt = torch.from_numpy(pred), torch.from_numpy(true)
    jp, jt = jnp.asarray(pred), jnp.asarray(true)
    for name in ("raw_pitch_accuracy", "raw_chroma_accuracy", "mean_octave_difference"):
        got, ref = float(getattr(tm, name)(tp, tt)), float(getattr(jm, name)(jp, jt))
        assert got == pytest.approx(ref, abs=1e-7), name
    assert 0.0 < float(tm.raw_pitch_accuracy(tp, tt)) < float(tm.raw_chroma_accuracy(tp, tt)) < 1.0
    assert float(tm.mean_octave_difference(tp, tt)) != 0.0
    hz = np.array([0.0, -5.0, 10.0, 440.0, 7902.1], np.float32)
    np.testing.assert_allclose(tm.hz_to_cents(torch.from_numpy(hz)).numpy(),
                               np.asarray(jm.hz_to_cents(jnp.asarray(hz))), rtol=1e-6)
    zero = torch.zeros((2, 16, 1))
    assert float(tm.mean_octave_difference(zero, tt[:2])) == 0.0


def test_pitch_metrics_on_random_pitches_within_a_frame():
    rng = np.random.default_rng(2)
    true = rng.uniform(40, 2000, (8, 1, 1)).astype(np.float32) * np.ones((1, 16, 1), np.float32)
    pred = (true * 2.0 ** rng.uniform(-2.2, 2.2, (8, 16, 1))).astype(np.float32)
    for name in ("raw_pitch_accuracy", "raw_chroma_accuracy", "mean_octave_difference"):
        got = float(getattr(tm, name)(torch.from_numpy(pred), torch.from_numpy(true)))
        ref = float(getattr(jm, name)(jnp.asarray(pred), jnp.asarray(true)))
        assert abs(got - ref) <= 1.0 / 128 + 1e-7, name


def test_compute_metrics_matches_jax():
    """Every gated metric, including pitch MSE on sorted unit pitches."""
    x, x_hat = _audio(batch=2, seed=3)
    pred, true = _pitches(batch=2, seed=4)
    rng = np.random.default_rng(5)
    unit, true_unit = (rng.random((2, 16, 1)).astype(np.float32) for _ in range(2))
    gates = {name: True for name in ALL_METRICS}
    got = tm.compute_metrics(gates, *(torch.from_numpy(a) for a in (x, x_hat, pred, true)),
                             frequency_unit=torch.from_numpy(unit),
                             true_frequency_unit=torch.from_numpy(true_unit))
    ref = jax.jit(lambda *a: jm.compute_metrics(gates, *a[:4], frequency_unit=a[4],
                                                true_frequency_unit=a[5]))(
        *(jnp.asarray(a) for a in (x, x_hat, pred, true, unit, true_unit)))
    assert set(got) == set(ref) == set(ALL_METRICS) | {"pitch_mse_db"}
    for k in ref:
        _close(got[k], ref[k], 1e-5)
    assert tm.compute_metrics({}, *(torch.from_numpy(a) for a in (x, x_hat, pred, true))) == {}
