"""Batched STFT magnitude (``sot_tpu/ops/stft.py``).

  * tf-style ``pad_end=True`` framing: n_frames = ceil(T / hop), the signal
    right-padded so the last window fits
  * ``center=False``: frame k covers samples [k*hop, k*hop + n_fft)
  * spectrum = rfft(window * frame); ``normalized=True`` divides by
    sqrt(n_fft)
  * magnitude = |rfft| with a zero-safe gradient (``_complex_abs``)

Framing is ``Tensor.unfold``; its autograd is the overlap-add the JAX
package writes out as a custom VJP (the same sums). ``center=True`` is the
loudness path, which is not ported yet: it raises. Output is time-major
[batch, frames, n_fft // 2 + 1].
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from sot_tpu_torch.ops.numerics import pad_for_stft_length
from sot_tpu_torch.ops.windows import get_window, hann_window


class _ComplexAbs(torch.autograd.Function):
    """sqrt(re^2 + im^2); the backward clamps |z| at 1e-20 so the gradient
    at a spectral zero is 0 instead of NaN."""

    @staticmethod
    def forward(ctx, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        mag = torch.sqrt(re * re + im * im)
        ctx.save_for_backward(re, im, mag)
        return mag

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        re, im, mag = ctx.saved_tensors
        safe = torch.clamp(mag, min=1e-20)
        return grad * re / safe, grad * im / safe


def _complex_abs(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return _ComplexAbs.apply(re, im)


def frame_signal(audio: torch.Tensor, frame_size: int, hop_length: int,
                 pad_end: bool = True) -> torch.Tensor:
    """[..., T] -> overlapping frames [..., n_frames, frame_size]."""
    t = audio.shape[-1]
    if pad_end:
        pad = pad_for_stft_length(t, frame_size, hop_length)
        if pad:
            audio = torch.nn.functional.pad(audio, (0, pad))
        n_frames = -(-t // hop_length)
    else:
        n_frames = 1 + (t - frame_size) // hop_length
    return audio.unfold(-1, frame_size, hop_length)[..., :n_frames, :]


def rfft_frequencies(n_fft: int, sample_rate: float) -> np.ndarray:
    """Bin centre frequencies in Hz (np.fft.rfftfreq semantics)."""
    return np.fft.rfftfreq(n_fft, d=1.0 / sample_rate).astype(np.float32)


def stft_magnitude(
    audio: torch.Tensor,
    size: int = 2048,
    overlap: float = 0.75,
    window: Optional[Union[str, np.ndarray, torch.Tensor]] = None,
    pad_end: bool = True,
    normalized: bool = True,
    time_major: bool = True,
    center: bool = False,
) -> torch.Tensor:
    """Magnitude STFT of [batch, T] audio -> [batch, frames, size//2+1].

    Hann window by default, a scipy window by name ('flattop'), 'ones' for
    rectangular, or an explicit array.
    """
    if center:
        raise NotImplementedError(
            "stft_magnitude(center=True) is the loudness path, which is not "
            "ported yet (ROADMAP)")
    audio = audio.to(torch.float32)
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    hop_length = int(size * (1.0 - overlap))
    if window is None:
        win = hann_window(size)
    elif isinstance(window, str):
        win = np.ones(size, np.float32) if window == "ones" else get_window(window, size)
    else:
        win = window
    win = torch.as_tensor(win, dtype=torch.float32, device=audio.device)
    frames = frame_signal(audio, size, hop_length, pad_end=pad_end)
    spec = torch.fft.rfft(frames * win, dim=-1)
    mag = _complex_abs(spec.real, spec.imag)
    if normalized:
        mag = mag / float(np.float32(np.sqrt(size)))
    if not time_major:
        mag = mag.transpose(-1, -2)
    return mag[0] if squeeze else mag
