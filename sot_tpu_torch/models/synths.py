"""Frozen sinusoidal/harmonic synthesizer (L3), port of ``sot_tpu/models/synths.py``.

The decoder has no parameters. Controls -> signal:

  get_controls: optional amp/freq scaling, harmonic expansion f0*[1..K],
                frame-rate Nyquist masking
  get_signal:   hann-OLA amplitude envelopes, bilinear frequency envelopes,
                oscillator bank — all through ``ops.kernels.synth.synth_render``
                (the CUDA kernel on the card, the plain PyTorch version on
                the CPU) where the JAX package takes its fused synth kernel:
                ``amp_resample_method="window"`` without
                ``use_angular_cumsum``; any other setting takes ``resample``
                and ``oscillator_bank``; with ``apply_roll_off``, the
                -6 dB/octave roll-off FIR above 500 Hz after it
                (``ops/fir.py``, MSS-LogLin)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from sot_tpu_torch.device import device_constant
from sot_tpu_torch.ops.fir import frequency_filter, slope_frequency_response
from sot_tpu_torch.ops.kernels.synth import synth_render
from sot_tpu_torch.ops.numerics import get_fn_by_name
from sot_tpu_torch.ops.oscillator import (get_harmonic_frequencies, oscillator_bank,
                                          remove_above_nyquist)
from sot_tpu_torch.ops.resample import resample


@dataclasses.dataclass(frozen=True)
class Sinusoidal:
    """Bank-of-sinusoids synth; `harmonic=True` expands f0 to integer multiples.

    Paper configs use amp_scale_fn=None, freq_scale_fn=None, harmonic=True,
    n_samples=4096.
    """

    n_samples: int = 64000
    sample_rate: int = 16000
    amp_scale_fn: Optional[Union[str, Callable]] = "exp_sigmoid"
    amp_resample_method: str = "window"
    freq_scale_fn: Optional[Union[str, Callable]] = "frequencies_softmax"
    harmonic: bool = False
    apply_roll_off: bool = False
    use_angular_cumsum: bool = False

    def get_controls(self, amplitudes: torch.Tensor,
                     frequencies: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[batch, time, n_sinusoids] network outputs -> synth controls."""
        amp_fn = get_fn_by_name(self.amp_scale_fn)
        freq_fn = get_fn_by_name(self.freq_scale_fn)
        if amp_fn is not None:
            amplitudes = amp_fn(amplitudes)
        if freq_fn is not None:
            frequencies = freq_fn(frequencies)
        if self.harmonic:
            frequencies = get_harmonic_frequencies(frequencies, amplitudes.shape[-1])
        amplitudes = remove_above_nyquist(frequencies, amplitudes, self.sample_rate)
        return {"amplitudes": amplitudes, "frequencies": frequencies}

    def get_signal(self, amplitudes: torch.Tensor,
                   frequencies: torch.Tensor) -> torch.Tensor:
        """Frame-rate controls -> [batch, n_samples] audio."""
        if self.amp_resample_method == "window" and not self.use_angular_cumsum:
            signal = synth_render(amplitudes.contiguous(), frequencies.contiguous(),
                                  self.n_samples, self.sample_rate)
        else:
            signal = oscillator_bank(
                resample(frequencies, self.n_samples),
                resample(amplitudes, self.n_samples, method=self.amp_resample_method,
                         add_endpoint=True),
                sample_rate=self.sample_rate, use_angular_cumsum=self.use_angular_cumsum)
        if self.apply_roll_off:
            # -6 dB/octave above 500 Hz (the MSS-LogLin experiment)
            filter_mag = device_constant(
                slope_frequency_response(6.0, n_freqs=65, f_ref=500.0)[0].numpy(), signal.device)
            filter_mag = filter_mag.expand(signal.shape[0], -1)
            signal = frequency_filter(signal, filter_mag)
        return signal

    def __call__(self, amplitudes: torch.Tensor, frequencies: torch.Tensor) -> torch.Tensor:
        controls = self.get_controls(amplitudes, frequencies)
        return self.get_signal(**controls)
