"""Port synth path (resample, oscillator bank, Sinusoidal, data) against the
JAX package.

Envelopes must be bit-equal (PERF.md, "The synth-kernel lesson"). Audio is
held to the tolerance the JAX package holds its own fused synth to (atol 2e-2,
correlation > 0.9999): the unwrapped phase reaches ~1e4 rad, where prefix
sums in another order differ by about an ulp (~1e-3 rad).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.models.synths import Sinusoidal as JaxSinusoidal  # noqa: E402
from sot_tpu.ops.resample import resample as jax_resample  # noqa: E402
from sot_tpu_torch.models.synths import Sinusoidal  # noqa: E402
from sot_tpu_torch.ops import resample as tres  # noqa: E402
from sot_tpu_torch.ops.kernels import synth as ksynth  # noqa: E402
from tests._torch_parity import corr  # noqa: E402


def _controls(b=8, frames=16, k=16, seed=0):
    """The JAX fused-synth tests' controls: some sinusoids above Nyquist."""
    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.05, 1.0, (b, frames, k)).astype(np.float32)
    f0 = rng.uniform(60.0, 900.0, (b, frames, 1)).astype(np.float32)
    return amps, f0 * np.arange(1, k + 1, dtype=np.float32)


@pytest.mark.parametrize("method", ["window", "bilinear"])
@pytest.mark.parametrize("shape,t", [((3, 16, 5), 4096), ((2, 16, 20), 4096),
                                     ((4, 8, 3), 1024)])
def test_envelopes_bit_equal_to_jax(method, shape, t):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 500.0
    ref = np.asarray(jax_resample(jnp.asarray(x), t, method=method, add_endpoint=True))
    got = tres.resample(torch.from_numpy(x), t, method=method, add_endpoint=True).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_synth_envelopes_plain_bit_equal_to_jax():
    amps, freqs = _controls(b=4, k=20, seed=5)
    masked = np.where(freqs >= 8000.0, 0.0, amps).astype(np.float32)
    env_f, env_a = ksynth.synth_envelopes_plain(torch.from_numpy(masked),
                                                torch.from_numpy(freqs), 4096, 16000)
    ref_f = np.asarray(jax_resample(jnp.asarray(freqs), 4096))
    ref_a = np.asarray(jax_resample(jnp.asarray(masked), 4096, method="window"))
    ref_a = np.where(ref_f >= 8000.0, 0.0, ref_a)
    np.testing.assert_array_equal(env_f.numpy(), ref_f)
    np.testing.assert_array_equal(env_a.numpy(), ref_a)


def test_prefix_sum_rounds_a_float64_accumulation():
    from sot_tpu_torch.ops.scan import prefix_sum

    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 3, (2, 4096, 3)).astype(np.float32))
    exact = np.cumsum(x.numpy().astype(np.float64), axis=1).astype(np.float32)
    np.testing.assert_array_equal(prefix_sum(x, axis=1).numpy(), exact)
    assert prefix_sum(torch.arange(5), axis=0).tolist() == [0, 1, 3, 6, 10]


@pytest.mark.parametrize("seed", [0, 1])
def test_sinusoidal_matches_jax(monkeypatch, seed):
    """Harmonic paper synth, [4, 16, 20] controls, both f32 on the CPU."""
    monkeypatch.delenv("SOT_TPU_SYNTH_PALLAS", raising=False)
    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.0, 1.0, (4, 16, 20)).astype(np.float32)
    f0 = rng.uniform(40.0, 1950.0, (4, 16, 1)).astype(np.float32)
    kw = dict(n_samples=4096, sample_rate=16000, amp_scale_fn=None,
              freq_scale_fn=None, harmonic=True)
    ref = np.asarray(JaxSinusoidal(**kw)(jnp.asarray(amps), jnp.asarray(f0)))
    got = Sinusoidal(**kw)(torch.from_numpy(amps), torch.from_numpy(f0)).numpy()
    assert got.shape == ref.shape == (4, 4096)
    np.testing.assert_allclose(got, ref, atol=2e-2)
    assert corr(got, ref) > 0.9999


def test_sinusoidal_matches_pallas_synth_in_interpret_mode(monkeypatch):
    """Against the TPU kernel (interpret mode) at its own tests' lane shapes."""
    amps, freqs = _controls()
    monkeypatch.setenv("SOT_TPU_SYNTH_PALLAS", "1")
    monkeypatch.setenv("SOT_TPU_PALLAS_INTERPRET", "1")
    kw = dict(n_samples=4096, sample_rate=16000, amp_scale_fn=None,
              freq_scale_fn=None, harmonic=False)
    jsynth = JaxSinusoidal(**kw)
    assert jsynth._use_fused_synth(jnp.asarray(amps))
    ref = np.asarray(jsynth.get_signal(jnp.asarray(amps), jnp.asarray(freqs)))
    got = Sinusoidal(**kw).get_signal(torch.from_numpy(amps), torch.from_numpy(freqs)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2)
    assert corr(got, ref) > 0.9999


def test_sinusoids_above_nyquist_contribute_exactly_zero():
    kw = dict(n_samples=4096, sample_rate=16000, amp_scale_fn=None,
              freq_scale_fn=None, harmonic=False)
    synth = Sinusoidal(**kw)
    amps = torch.ones(2, 16, 4)
    above = torch.full((2, 16, 4), 9000.0)
    assert torch.count_nonzero(synth(amps, above)) == 0
    # an audible sinusoid alone == the same sinusoid plus inaudible ones
    f = torch.full((2, 16, 1), 440.0)
    alone = synth(amps[..., :1], f)
    mixed = synth(amps, torch.cat([f, above[..., 1:]], dim=-1))
    assert torch.equal(alone, mixed)


def test_roll_off_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Sinusoidal(apply_roll_off=True)


def test_dataset_draws_match_jax():
    from sot_tpu import data as jdata
    from sot_tpu_torch import data as tdata

    kw = dict(seed=5, size=6, render_batch=4, mask_rand_amplitudes=True)
    j_sig, j_f, j_a = jdata.generate_sinusoid_dataset(**kw)
    t_sig, t_f, t_a = tdata.generate_sinusoid_dataset(device="cpu", **kw)
    np.testing.assert_array_equal(t_f, j_f)
    np.testing.assert_array_equal(t_a, j_a)
    # raw clips sum up to 8 unit-amplitude partials: the phase-order noise
    # scales with that sum; peak-normalised clips are what the model sees
    j_x, t_x = jdata.peak_normalize(j_sig), tdata.peak_normalize(t_sig)
    np.testing.assert_allclose(t_x, j_x, atol=2e-2)
    assert corr(t_x, j_x) > 0.9999
    np.testing.assert_array_equal(tdata.peak_normalize(j_sig), j_x)


def test_dataset_needs_an_explicit_device_without_cuda(monkeypatch):
    from sot_tpu_torch import data as tdata

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.generate_sinusoid_dataset(size=2)
