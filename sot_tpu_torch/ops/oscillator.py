"""Sinusoidal oscillator bank (``sot_tpu/ops/oscillator.py``).

  * harmonic expansion: f0 * [1..K]
  * Nyquist masking of amplitudes (``>=``)
  * phase = cumsum(2*pi*f / sr) along time (unwrapped), sin, weighted sum
    over sinusoids

``angular_cumsum`` (the chunked mod-2pi variant) is not ported yet (ROADMAP).
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


def oscillator_bank(frequency_envelopes: torch.Tensor,
                    amplitude_envelopes: torch.Tensor,
                    sample_rate: int = 16000,
                    sum_sinusoids: bool = True) -> torch.Tensor:
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
    phases = prefix_sum(omegas, axis=1)
    audio = amplitude_envelopes * torch.sin(phases)
    if sum_sinusoids:
        audio = torch.sum(audio, dim=-1)
    return audio
