"""Gradients of the port's synth against ``jax.grad`` through the JAX
package's ``Sinusoidal``, and the B3 backward kernel's algorithm against
autograd of the plain version.

The CUDA backward kernel (``csrc/synth.cu``: ``synth_lane_bwd_kernel``)
runs only on the card; here a numpy transcription of its algorithm (the
same tables, the same float64 phase and suffix sum, the same per-frame
ranges and window taps) is held against autograd of ``synth_render_plain``,
so the transposition the kernel writes out is checked on the CPU.

Tolerances: against JAX, d amplitudes and d frequencies within 5e-3 of
their max (the JAX phase is a blocked f32 prefix sum and the port's a
float64 one; at ~1e4 rad they differ by ~1e-3 rad, which cos/sin carry into
every sample's cotangent: measured up to 1.7e-3). Kernel transcription
against autograd: 1e-5 of the max (the same phase; only the order of the
per-frame sums differs).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.models.synths import Sinusoidal as JaxSinusoidal  # noqa: E402
from sot_tpu_torch.models.synths import Sinusoidal  # noqa: E402
from sot_tpu_torch.ops.kernels import synth as ksynth  # noqa: E402
from sot_tpu_torch.ops.numerics import exp_sigmoid  # noqa: E402
from sot_tpu_torch.ops.resample import linear_taps  # noqa: E402
from tests._torch_parity import rel_max_err  # noqa: E402

SR, T = 16000, 4096


def _jax_grads(synth, amps, freqs, dout, harmonic):
    def loss(a, f):
        out = synth(a, f) if harmonic else synth.get_signal(a, f)
        return jnp.sum(out * jnp.asarray(dout))

    ga, gf = jax.grad(loss, argnums=(0, 1))(jnp.asarray(amps), jnp.asarray(freqs))
    return np.asarray(ga), np.asarray(gf)


def _port_grads(synth, amps, freqs, dout, harmonic):
    a = torch.from_numpy(amps).requires_grad_(True)
    f = torch.from_numpy(freqs).requires_grad_(True)
    out = synth(a, f) if harmonic else synth.get_signal(a, f)
    torch.sum(out * torch.from_numpy(dout)).backward()
    return a.grad.numpy(), f.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_paper_synth_gradients_match_jax(monkeypatch, seed):
    """The harmonic paper synth, [2, 16, 20] exp-sigmoid amplitudes and f0
    in the data range, some harmonics above Nyquist: gradients to the
    amplitudes and to f0 through the harmonic expansion and the mask."""
    monkeypatch.delenv("SOT_TPU_SYNTH_PALLAS", raising=False)
    rng = np.random.default_rng(seed)
    amps = exp_sigmoid(torch.from_numpy(rng.standard_normal((2, 16, 20)).astype(np.float32)))
    amps = amps.numpy()
    f0 = rng.uniform(40.0, 1950.0, (2, 16, 1)).astype(np.float32)
    dout = rng.standard_normal((2, T)).astype(np.float32)
    kw = dict(n_samples=T, sample_rate=SR, amp_scale_fn=None, freq_scale_fn=None,
              harmonic=True)
    ga_ref, gf_ref = _jax_grads(JaxSinusoidal(**kw), amps, f0, dout, True)
    ga, gf = _port_grads(Sinusoidal(**kw), amps, f0, dout, True)
    assert rel_max_err(ga, ga_ref) <= 5e-3
    assert rel_max_err(gf, gf_ref) <= 5e-3
    # a harmonic at/above Nyquist in every frame passes no gradient
    dead = (f0 * np.arange(1, 21) >= SR / 2).all(axis=1)
    assert np.all(ga.transpose(0, 2, 1)[dead] == 0.0)


@pytest.mark.parametrize("gate", ["", "1"])
def test_synth_gradients_match_jax_with_and_without_pallas(monkeypatch, gate):
    """Against the JAX synth's XLA path and its Pallas kernel pair (the
    ``_bwd_kernel`` this slice ports, in interpret mode) at the kernel's
    own tests' lane shape (8 clips x 16 sinusoids = 128 lanes)."""
    monkeypatch.setenv("SOT_TPU_SYNTH_PALLAS", gate)
    monkeypatch.setenv("SOT_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(3)
    amps = rng.uniform(0.05, 1.0, (8, 16, 16)).astype(np.float32)
    freqs = (rng.uniform(60.0, 900.0, (8, 16, 1)) * np.arange(1, 17)).astype(np.float32)
    amps = np.where(freqs >= SR / 2, 0.0, amps).astype(np.float32)  # frame-rate mask
    dout = rng.standard_normal((8, T)).astype(np.float32)
    kw = dict(n_samples=T, sample_rate=SR, amp_scale_fn=None, freq_scale_fn=None,
              harmonic=False)
    jsynth = JaxSinusoidal(**kw)
    assert jsynth._use_fused_synth(jnp.asarray(amps)) == (gate == "1")
    ga_ref, gf_ref = _jax_grads(jsynth, amps, freqs, dout, False)
    ga, gf = _port_grads(Sinusoidal(**kw), amps, freqs, dout, False)
    assert rel_max_err(ga, ga_ref) <= 5e-3
    assert rel_max_err(gf, gf_ref) <= 5e-3


def _kernel_backward_transcription(amps, freqs, dout):
    """csrc/synth.cu ``synth_lane_bwd_kernel`` in numpy: (d amplitudes,
    d frequencies), each [B, F, K]."""
    b, n_frames, k = amps.shape
    lo, frac, window, lo_start, hi_start = (t.numpy() for t in ksynth._tables(
        n_frames, T, torch.device("cpu")))
    nyquist, omega_scale = (np.float32(v) for v in ksynth._scalars(SR))
    env_f, env_a = (t.numpy() for t in ksynth.synth_envelopes_plain(
        torch.from_numpy(amps), torch.from_numpy(freqs), T, SR))  # [B, T, K]
    hop = T // n_frames
    d_amps = np.zeros_like(amps)
    d_freqs = np.zeros_like(freqs)
    for bi in range(b):
        g = dout[bi][:, None]
        inc = (env_f[bi] * omega_scale).astype(np.float32)
        phase = np.cumsum(inc.astype(np.float64), axis=0).astype(np.float32)
        s, c = np.sin(phase), np.cos(phase)
        da = np.where(env_f[bi] >= nyquist, np.float32(0), (g * s).astype(np.float32))
        dph = ((g * env_a[bi]).astype(np.float32) * c).astype(np.float32)
        suf = np.cumsum(dph[::-1].astype(np.float64), axis=0)[::-1].astype(np.float32)
        df = (suf * omega_scale).astype(np.float32)
        for f in range(n_frames):
            lo_r = slice(lo_start[f], lo_start[f + 1])
            hi_r = slice(hi_start[f], hi_start[f + 1])
            d_freqs[bi, f] = ((df[lo_r] - frac[lo_r, None] * df[lo_r]).sum(0)
                              + (frac[hi_r, None] * df[hi_r]).sum(0))
            acc = (window[hop:, None] * da[f * hop:(f + 1) * hop]).sum(0)
            if f > 0:
                acc += (window[:hop, None] * da[(f - 1) * hop:f * hop]).sum(0)
            if f == n_frames - 1:
                acc += (window[:hop, None] * da[f * hop:(f + 1) * hop]).sum(0)
            d_amps[bi, f] = acc
    return d_amps, d_freqs


def test_backward_kernel_algorithm_matches_autograd_of_plain():
    rng = np.random.default_rng(7)
    f0 = rng.uniform(40.0, 1950.0, (2, 16, 1)).astype(np.float32)
    freqs = (f0 * np.arange(1, 21)).astype(np.float32)
    amps = np.where(freqs >= SR / 2, 0.0, rng.uniform(0.0, 2.0, (2, 16, 20))).astype(np.float32)
    dout = rng.standard_normal((2, T)).astype(np.float32)
    a = torch.from_numpy(amps).requires_grad_(True)
    f = torch.from_numpy(freqs).requires_grad_(True)
    torch.sum(ksynth.synth_render_plain(a, f, T, SR) * torch.from_numpy(dout)).backward()
    ta, tf = _kernel_backward_transcription(amps, freqs, dout)
    assert rel_max_err(ta, a.grad.numpy()) <= 1e-5
    assert rel_max_err(tf, f.grad.numpy()) <= 1e-5


@pytest.mark.parametrize("n_frames,n_samples", [(16, 4096), (8, 1024), (32, 8192)])
def test_backward_tables_partition_the_samples(n_frames, n_samples):
    """Each frame's lo / hi sample range is exactly the samples whose
    bilinear tap points at it; the ranges tile [0, n_samples)."""
    lo, hi, _ = linear_taps(n_frames, n_samples, align_corners=False)
    _, _, window, lo_start, hi_start = (t.numpy() for t in ksynth._tables(
        n_frames, n_samples, torch.device("cpu")))
    assert window.shape == (2 * (n_samples // n_frames),)
    for idx, start in ((lo, lo_start), (hi, hi_start)):
        assert start[0] == 0 and start[-1] == n_samples
        for fr in range(n_frames):
            assert np.all(idx[start[fr]:start[fr + 1]] == fr)
    assert math.isclose(float(window.max()), 1.0, rel_tol=1e-6)


def test_synth_render_is_differentiable_on_the_cpu():
    """On a CPU tensor the wrapper is the plain version under autograd and
    launches nothing."""
    amps = torch.rand(1, 16, 3, requires_grad=True)
    freqs = torch.full((1, 16, 3), 440.0, requires_grad=True)
    before = (ksynth.launches, ksynth.backward_launches)
    out = ksynth.synth_render(amps, freqs, T, SR)
    assert out.grad_fn is not None
    out.sum().backward()
    assert amps.grad is not None and freqs.grad is not None
    assert (ksynth.launches, ksynth.backward_launches) == before
