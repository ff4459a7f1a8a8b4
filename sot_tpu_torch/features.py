"""Feature transforms (L2): STFT, CQT and identity with frequency metadata
(``sot_tpu/features.py``).

Every transform is a small hashable config object exposing
  * ``__call__(audio)`` -> (batch, time, freq) features
  * ``get_frequencies()`` -> np.ndarray of bin centre frequencies in Hz

The CQT is the encoder's input; the STFT is the loss domain.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sot_tpu_torch.kernel_gates import Kernels, resolve_gates
from sot_tpu_torch.ops.cqt import cqt_frequencies, cqt_magnitude
from sot_tpu_torch.ops.numerics import safe_log
from sot_tpu_torch.ops.stft import rfft_frequencies, stft_magnitude


@dataclasses.dataclass(frozen=True)
class STFT:
    """Magnitude STFT, time-major. ``kernels`` (a ``KernelGates`` or a
    preset name): its ``stft_frontend`` gate sends the transform to kernel
    B9 where the JAX package's conditions hold, its ``dft_matmul`` gate the
    |rfft| to one matmul."""

    n_fft: int = 1024
    hop_length: int = 256
    sample_rate: int = 16000
    window: Optional[str] = None  # None -> hann; 'flattop' for the SOT loss domain
    log: bool = False
    kernels: Kernels = "auto"

    def __call__(self, audio: torch.Tensor, reduce: bool = False,
                 log: bool = False) -> torch.Tensor:
        gates = resolve_gates(self.kernels)
        x = stft_magnitude(audio, size=self.n_fft,
                           overlap=1.0 - self.hop_length / self.n_fft, window=self.window,
                           frontend=gates.stft_frontend, dft_matmul=gates.dft_matmul)
        if reduce:
            x = torch.mean(x, dim=1)
        if log or self.log:
            x = safe_log(x)
        return x

    def get_frequencies(self) -> np.ndarray:
        return rfft_frequencies(self.n_fft, self.sample_rate)


@dataclasses.dataclass(frozen=True)
class CQT:
    """Magnitude CQT, time-major."""

    sample_rate: int = 16000
    fmin: float = 32.7
    bins_per_semitone: int = 3
    n_bins: int = 285
    hop_length: int = 256
    log: bool = False

    @property
    def bins_per_octave(self) -> int:
        return 12 * self.bins_per_semitone

    def __call__(self, audio: torch.Tensor, reduce: bool = False,
                 log: bool = False) -> torch.Tensor:
        x = cqt_magnitude(audio, sr=self.sample_rate, fmin=self.fmin,
                          n_bins=self.n_bins, bins_per_octave=self.bins_per_octave,
                          hop_length=self.hop_length)
        if log or self.log:
            # reference scales log-CQT by 20 with a float32-eps clamp
            x = safe_log(x, eps=float(np.finfo(np.float32).eps)) * 20.0
        if reduce:
            x = torch.mean(x, dim=1, keepdim=True)
        return x

    def get_frequencies(self) -> np.ndarray:
        return cqt_frequencies(self.sample_rate, self.fmin, self.n_bins,
                               self.bins_per_octave)


@dataclasses.dataclass(frozen=True)
class Identity:
    """Loss on raw audio (MSS experiments)."""

    def __call__(self, audio: torch.Tensor, **_kwargs) -> torch.Tensor:
        return audio

    def get_frequencies(self) -> Optional[np.ndarray]:
        return None
