"""Sinusoidal oscillator bank (``sot_tpu/ops/oscillator.py``).

  * harmonic expansion: f0 * [1..K]
  * Nyquist masking of amplitudes (``>=``)
  * phase = cumsum(2*pi*f / sr) along time (unwrapped), sin, weighted sum
    over sinusoids

``angular_cumsum`` is the chunked mod-2pi variant (``use_angular_cumsum``):
each 1000-sample chunk's prefix, the chunk-end phases carried forward mod
2pi, the phase returned in [0, 2pi). Its prefixes go through
``ops/scan.prefix_sum`` (float64 accumulation, one rounding to f32), so
that the GPU's sequential f32 ``cumsum`` does not drift from the CPU's; the
JAX package's f32 ``jnp.cumsum`` sums in another order, so the two agree
through ``sin`` of the phase, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from sot_tpu_torch.ops.scan import prefix_sum

_TWO_PI = 2.0 * math.pi


def get_harmonic_frequencies(frequencies: torch.Tensor, n_harmonics: int) -> torch.Tensor:
    """f0 [batch, time, 1] -> integer multiples [batch, time, n_harmonics]."""
    frequencies = frequencies.to(torch.float32)
    f_ratios = torch.linspace(1.0, float(n_harmonics), int(n_harmonics),
                              dtype=torch.float32, device=frequencies.device)
    return frequencies * f_ratios


def remove_above_nyquist(frequency_envelopes: torch.Tensor,
                         amplitude_envelopes: torch.Tensor,
                         sample_rate: int = 16000) -> torch.Tensor:
    """Zero amplitudes of oscillators at/above Nyquist."""
    amplitude_envelopes = amplitude_envelopes.to(torch.float32)
    return torch.where(frequency_envelopes.to(torch.float32) >= sample_rate / 2.0,
                       torch.zeros_like(amplitude_envelopes), amplitude_envelopes)


def angular_cumsum(angular_frequency: torch.Tensor, chunk_size: int = 1000) -> torch.Tensor:
    """Chunked phase accumulation with mod-2pi stitching along axis 1 of
    [batch, time, ...]: the fp error stays bounded whatever the signal's
    length. Returns the phase in [0, 2pi)."""
    x = angular_frequency.to(torch.float32)
    n_batch, n_time = x.shape[0], x.shape[1]
    tail = tuple(x.shape[2:])
    pad = (chunk_size - n_time % chunk_size) % chunk_size
    if pad:
        x = torch.cat([x, x.new_zeros((n_batch, pad) + tail)], dim=1)
    length = n_time + pad
    phase = prefix_sum(x.reshape((n_batch, length // chunk_size, chunk_size) + tail), axis=2)

    # each chunk's carry: the earlier chunks' end phases mod 2pi, summed mod 2pi
    ends = torch.remainder(phase[:, :, -1:], _TWO_PI)
    offsets = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    offsets = torch.remainder(prefix_sum(offsets, axis=1), _TWO_PI)

    phase = torch.remainder(phase + offsets, _TWO_PI).reshape((n_batch, length) + tail)
    return phase[:, :n_time] if pad else phase


def oscillator_bank(frequency_envelopes: torch.Tensor,
                    amplitude_envelopes: torch.Tensor,
                    sample_rate: int = 16000,
                    sum_sinusoids: bool = True,
                    use_angular_cumsum: bool = False) -> torch.Tensor:
    """Audio from sample-wise envelopes.

    Args:
      frequency_envelopes: [batch, n_samples, n_sinusoids] Hz.
      amplitude_envelopes: [batch, n_samples, n_sinusoids].
    Returns: [batch, n_samples] if sum_sinusoids else the per-sinusoid stack.
    """
    frequency_envelopes = frequency_envelopes.to(torch.float32)
    amplitude_envelopes = remove_above_nyquist(
        frequency_envelopes, amplitude_envelopes, sample_rate)
    omegas = frequency_envelopes * (_TWO_PI / float(sample_rate))
    phases = angular_cumsum(omegas) if use_angular_cumsum else prefix_sum(omegas, axis=1)
    audio = amplitude_envelopes * torch.sin(phases)
    if sum_sinusoids:
        audio = torch.sum(audio, dim=-1)
    return audio
