"""Feature transforms (L2): STFT, CQT and identity with frequency metadata
(``sot_tpu/features.py``).

Every transform is a small hashable config object exposing
  * ``__call__(audio)`` -> (batch, time, freq) features
  * ``get_frequencies()`` -> np.ndarray of bin centre frequencies in Hz

The CQT is the encoder's input; the STFT is the loss domain. ``get_transform``
builds either (or the identity) from a name or a config dict. The loudness
functions (``a_weighting_db``, ``a_weighting_from_audio``, ``get_loudness``)
give the A-weighted per-frame loudness of audio.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from sot_tpu_torch.kernel_gates import Kernels, resolve_gates
from sot_tpu_torch.ops.cqt import cqt_frequencies, cqt_magnitude
from sot_tpu_torch.device import device_constant
from sot_tpu_torch.ops.numerics import get_cqt_n_bins, power_to_db, safe_log
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


Transform = Union[STFT, CQT, Identity]


def get_transform(transform: Union[str, dict, None], sample_rate: int) -> Transform:
    """A transform from a name or a config dict, e.g.
      {'type': 'stft', 'n_fft': 2048, 'hop_length': 256, 'window': 'flattop'}
      {'type': 'cqt', 'fmin': 32.7, 'bins_per_semitone': 3, 'n_bins': 'auto'}
    (None -> ``Identity``). Keys the transforms do not take (center,
    output_format, pad_mode) are accepted and ignored."""
    if transform is None:
        return Identity()
    if isinstance(transform, dict):
        kwargs = dict(transform)
        name = kwargs.pop("type")
    else:
        name, kwargs = transform, {}

    if name == "stft":
        return STFT(n_fft=int(kwargs.get("n_fft", 1024)),
                    hop_length=int(kwargs.get("hop_length", 256)),
                    sample_rate=sample_rate, window=kwargs.get("window", None),
                    log=bool(kwargs.get("log", False)))
    if name == "cqt":
        fmin = float(kwargs.get("fmin", 32.7))
        bps = int(kwargs.get("bins_per_semitone", 3))
        n_bins = kwargs.get("n_bins", "auto")
        if n_bins == "auto" or n_bins is None:
            n_bins = get_cqt_n_bins(sample_rate, fmin, bps)
        return CQT(sample_rate=sample_rate, fmin=fmin, bins_per_semitone=bps,
                   n_bins=int(n_bins), hop_length=int(kwargs.get("hop_length", 256)),
                   log=bool(kwargs.get("log", False)))
    if name == "identity":
        return Identity()
    raise ValueError(f"Unknown transform {name}")


# ---------------------------------------------------------------------------
# Loudness
# ---------------------------------------------------------------------------


def a_weighting_db(frequencies: np.ndarray, min_db: float = -80.0) -> np.ndarray:
    """IEC 61672 A-weighting curve in dB (librosa.A_weighting semantics),
    the closed-form pole/zero expression in float64, clamped at ``min_db``
    and cast to float32."""
    f = np.asarray(frequencies, np.float64)
    f2 = f * f
    c1, c2, c3, c4 = 20.6 ** 2, 107.7 ** 2, 737.9 ** 2, 12194.0 ** 2
    num = c4 * f2 * f2
    den = (f2 + c1) * np.sqrt((f2 + c2) * (f2 + c3)) * (f2 + c4)
    with np.errstate(divide="ignore"):
        weights = 2.0 + 20.0 * (np.log10(num) - np.log10(den))
    return np.maximum(weights, min_db).astype(np.float32)


def a_weighting_from_audio(audio: torch.Tensor, num_fft: int, hopsize: int,
                           sample_rate: int = 16000,
                           weighting: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-frame A-weighted loudness in dB: torch.stft's centre reflect
    padding, a rectangular window, unnormalised; the power spectrum weighted
    by the linear-scale A-curve (``weighting``, by default from
    ``a_weighting_db``), averaged over frequency, then
    ``power_to_db(ref_db=0, range_db=80)``. [batch, T] -> [batch, n_frames]
    (or [T] -> [n_frames])."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    is_1d = audio.ndim == 1
    if is_1d:
        audio = audio[None]
    mag = stft_magnitude(audio, size=num_fft, overlap=1.0 - hopsize / num_fft, window="ones",
                         normalized=False, center=True, pad_end=False)
    power = mag * mag
    if weighting is None:
        freqs = rfft_frequencies(num_fft, sample_rate)
        weighting = device_constant((10.0 ** (a_weighting_db(freqs) / 10.0)).astype(np.float32),
                                    audio.device)
    loudness = power_to_db(torch.mean(power * weighting, dim=-1), ref_db=0.0, range_db=80.0)
    return loudness[0] if is_1d else loudness


def get_loudness(audio: torch.Tensor, hopsize: int, num_fft: int = 1024,
                 sample_rate: int = 16000,
                 weighting: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalised loudness in ~[0, 1]: (A-weighted dB + 50) / 80."""
    return (a_weighting_from_audio(audio, num_fft, hopsize, sample_rate,
                                   weighting=weighting) + 50.0) / 80.0
