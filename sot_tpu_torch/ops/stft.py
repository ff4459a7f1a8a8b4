"""Batched STFT magnitude (``sot_tpu/ops/stft.py``).

  * tf-style ``pad_end=True`` framing: n_frames = ceil(T / hop), the signal
    right-padded so the last window fits
  * ``center=False``: frame k covers samples [k*hop, k*hop + n_fft)
  * spectrum = rfft(window * frame); ``normalized=True`` divides by
    sqrt(n_fft)
  * magnitude = |rfft| with a zero-safe gradient (``_complex_abs``)

Framing is ``Tensor.unfold``; its autograd is the overlap-add the JAX
package writes out as a custom VJP (the same sums). With ``frontend`` (the
``stft_frontend`` gate, ``SOT_TPU_STFT_PALLAS`` in the JAX package) the
framing, window and DFT run fused in kernel B9 (``ops/kernels/stft.py``)
wherever the JAX package's conditions hold; with ``dft_matmul``
(``SOT_TPU_DFT_MATMUL``) the |rfft| of the windowed frames is one f32
matmul against the real-DFT matrix for n_fft <= 4096. ``center=True`` is the
loudness path, which is not ported yet: it raises. Output is time-major
[batch, frames, n_fft // 2 + 1].
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch

from sot_tpu_torch.ops.kernels.stft import frontend_applicable, stft_frontend_projection
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


@functools.lru_cache(maxsize=16)
def _dft_matrix(n_fft: int) -> np.ndarray:
    """Real-DFT basis [n_fft, 2 * (n_fft // 2 + 1)]: frames @ M = [re | im]
    of the rfft (``sot_tpu/ops/stft.py:_dft_matrix``'s f32 table)."""
    k = np.arange(n_fft // 2 + 1)
    t = np.arange(n_fft)
    ang = 2.0 * np.pi * t[:, None] * k[None, :] / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def _dft_matmul_magnitude(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """|rfft(frames)| as one f32 matmul against ``_dft_matrix`` (full f32
    under the port's precision policy, TF32 off, as the JAX package asks
    for HIGHEST precision)."""
    proj = torch.matmul(frames, torch.from_numpy(_dft_matrix(n_fft)).to(frames.device))
    n_bins = n_fft // 2 + 1
    return _complex_abs(proj[..., :n_bins], proj[..., n_bins:])


def stft_magnitude(
    audio: torch.Tensor,
    size: int = 2048,
    overlap: float = 0.75,
    window: Optional[Union[str, np.ndarray, torch.Tensor]] = None,
    pad_end: bool = True,
    normalized: bool = True,
    time_major: bool = True,
    center: bool = False,
    frontend: bool = False,
    dft_matmul: bool = False,
) -> torch.Tensor:
    """Magnitude STFT of [batch, T] audio -> [batch, frames, size//2+1].

    Hann window by default, a scipy window by name ('flattop'), 'ones' for
    rectangular, or an explicit array. ``frontend`` sends [batch, T] audio
    with a numpy window to kernel B9 where ``frontend_applicable`` holds
    (``sot_tpu/ops/stft.py:206-222``); else ``dft_matmul`` computes the
    |rfft| of the windowed frames as one matmul for ``size`` <= 4096.
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
    if (frontend and audio.ndim == 2 and isinstance(win, np.ndarray)
            and frontend_applicable(size, hop_length, audio.shape[-1], pad_end, center)):
        proj = stft_frontend_projection(audio, size, hop_length, win)
        n_bins = size // 2 + 1
        mag = _complex_abs(proj[..., :n_bins], proj[..., n_bins:])
    else:
        win = torch.as_tensor(win, dtype=torch.float32, device=audio.device)
        frames = frame_signal(audio, size, hop_length, pad_end=pad_end)
        if dft_matmul and size <= 4096:
            mag = _dft_matmul_magnitude(frames * win, size)
        else:
            spec = torch.fft.rfft(frames * win, dim=-1)
            mag = _complex_abs(spec.real, spec.imag)
    if normalized:
        mag = mag / float(np.float32(np.sqrt(size)))
    if not time_major:
        mag = mag.transpose(-1, -2)
    return mag[0] if squeeze else mag
