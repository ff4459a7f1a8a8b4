"""Plain DSP of the reference: windows, the CQT bank and projection, the
magnitude STFT and the harmonic synth, in float32 PyTorch (numpy for the
host-side tables). Written from the semantics the port documents, not from
its code:

  * CQT (librosa / nnAudio CQT1992v2): Q = 1 / (2^(1/bpo) - 1), bins
    f_k = fmin 2^(k/bpo), kernel k a periodic hann of l_k = ceil(Q sr / f_k)
    samples times exp(2 pi i f_k n / sr), L1-normalised, scaled by sqrt(l_k),
    centred in a power-of-two width; the audio zero-padded by half that
    width on each side, frames every hop; magnitude of the projection.
  * STFT: tf-style ``pad_end`` framing (ceil(T / hop) frames, the end
    zero-padded so the last window fits), rfft of the windowed frames,
    magnitude divided by sqrt(n_fft).
  * Synth: harmonics f0 * [1..K], amplitudes zeroed at frame rate where a
    harmonic is at or above Nyquist; the amplitude envelope a hann
    overlap-add of the frames (the last frame repeated), the frequency
    envelope bilinear (align_corners false, fractions from float64 rounded
    once); the amplitude zeroed again per sample where the envelope is at or
    above Nyquist; the phase a float64 prefix sum of the float32 increments
    f * float32(2 pi / sr), rounded once to float32; sin; the harmonics
    summed in k order from +0.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def cosine_window(n: int, coeffs) -> np.ndarray:
    """Periodic generalised-cosine window (scipy ``fftbins=True``):
    sum_k (-1)^k a_k cos(2 pi k m / n), built in float64, returned float32."""
    m = np.arange(n, dtype=np.float64)
    w = np.zeros(n, np.float64)
    for k, a in enumerate(coeffs):
        w += (-1.0) ** k * a * np.cos(2.0 * np.pi * k * m / n)
    return w.astype(np.float32)


HANN = (0.5, 0.5)
FLATTOP = (0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368)


def window(name: str, n: int) -> np.ndarray:
    return cosine_window(n, {"hann": HANN, "flattop": FLATTOP}[name])


def cqt_bins(sample_rate: int, fmin: float, bins_per_semitone: int) -> int:
    """Bins from fmin up to Nyquist, whole semitones."""
    semitones = int(math.floor(12 * math.log2(sample_rate / 2) - 12 * math.log2(fmin)))
    return semitones * bins_per_semitone


def cqt_frequencies(sample_rate: int, fmin: float, n_bins: int, bpo: int) -> np.ndarray:
    return fmin * 2.0 ** (np.arange(n_bins, dtype=np.float64) / bpo)


def cqt_lengths(sample_rate: int, fmin: float, n_bins: int, bpo: int) -> np.ndarray:
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    return np.ceil(q * sample_rate / cqt_frequencies(sample_rate, fmin, n_bins, bpo)
                   ).astype(np.int64)


def cqt_bank(sample_rate: int, fmin: float, n_bins: int, bpo: int) -> np.ndarray:
    """[width, 2 * n_bins] float32: the real parts of the kernels, then the
    negated imaginary parts (correlation with the conjugate)."""
    freqs = cqt_frequencies(sample_rate, fmin, n_bins, bpo)
    lengths = cqt_lengths(sample_rate, fmin, n_bins, bpo)
    width = 1 << int(math.ceil(math.log2(lengths[0])))
    bank = np.zeros((width, 2 * n_bins), np.float32)
    for k in range(n_bins):
        l = int(lengths[k])
        start = int(math.ceil(width / 2.0 - l / 2.0)) - (l % 2)
        n = np.arange(-(l // 2), l - l // 2, dtype=np.float64)
        hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(l) / l)
        sig = hann * np.exp(2j * np.pi * freqs[k] * n / sample_rate) / l
        sig = sig / np.abs(sig).sum() * np.sqrt(l)
        bank[start:start + l, k] = sig.real
        bank[start:start + l, n_bins + k] = -sig.imag
    return bank


def cqt_magnitude(audio: torch.Tensor, bank: torch.Tensor, hop: int, mm) -> torch.Tensor:
    """[B, T] -> [B, frames, n_bins]; ``mm`` is the reference's matmul
    (which rounds operands for the lower-precision control)."""
    width = bank.shape[0]
    n_bins = bank.shape[1] // 2
    padded = torch.nn.functional.pad(audio, (width // 2, width // 2))
    frames = padded.unfold(-1, width, hop)  # [B, F, width]
    proj = mm(frames.reshape(-1, width), bank).reshape(audio.shape[0], -1, 2 * n_bins)
    re, im = proj[..., :n_bins], proj[..., n_bins:]
    return torch.sqrt(re * re + im * im)


def stft_magnitude(audio: torch.Tensor, n_fft: int, hop: int, win: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, ceil(T / hop), n_fft // 2 + 1]."""
    t = audio.shape[-1]
    n_frames = -(-t // hop)
    pad = max(0, n_fft + hop * (n_frames - 1) - t)
    frames = torch.nn.functional.pad(audio, (0, pad)).unfold(-1, n_fft, hop)[:, :n_frames]
    spec = torch.fft.rfft(frames * win, dim=-1)
    return torch.abs(spec) / float(np.float32(np.sqrt(n_fft)))


def bilinear_taps(n_frames: int, n_samples: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, frac) of linear interpolation with align_corners false: the
    source coordinate clipped to the frames, the last interval kept at its
    end (lo <= n_frames - 2), frac from float64 rounded once."""
    scale = n_frames / n_samples
    coords = np.clip((np.arange(n_samples, dtype=np.float64) + 0.5) * scale - 0.5,
                     0.0, n_frames - 1)
    lo = np.minimum(np.floor(coords).astype(np.int64), n_frames - 2)
    frac = (coords - lo).astype(np.float32)
    return lo, lo + 1, frac


def float32_prefix(x: torch.Tensor) -> torch.Tensor:
    """Prefix sum along axis 1 accumulated in float32, one sample after the
    other: the card's float32 ``cumsum`` along that axis; the CPU's sums in
    float64, so there it is written out."""
    if x.device.type == "cuda":
        return torch.cumsum(x, dim=1)
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[:, 0])
    for t in range(x.shape[1]):
        acc = acc + x[:, t]
        out[:, t] = acc
    return out


def synth(amplitudes: torch.Tensor, f0_hz: torch.Tensor, n_samples: int,
          sample_rate: int, phase_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Frame-rate amplitudes [B, F, K] and f0 [B, F, 1] (Hz) -> [B, n_samples];
    the phase prefix accumulated in ``phase_dtype``."""
    dev = amplitudes.device
    batch, n_frames, k = amplitudes.shape
    nyquist = sample_rate / 2.0
    freqs = f0_hz * torch.arange(1, k + 1, dtype=torch.float32, device=dev)
    amps = torch.where(freqs >= nyquist, torch.zeros_like(amplitudes), amplitudes)

    hop = n_samples // n_frames
    w = torch.from_numpy(window("hann", 2 * hop)).to(dev)
    ext = torch.cat([amps, amps[:, -1:]], dim=1)  # [B, F + 1, K]
    rise = ext[:, 1:, None, :] * w[None, None, :hop, None]
    fall = ext[:, :-1, None, :] * w[None, None, hop:, None]
    env_a = (rise + fall).reshape(batch, n_samples, k)

    lo, hi, frac = (torch.from_numpy(a).to(dev) for a in bilinear_taps(n_frames, n_samples))
    f_lo, f_hi = freqs[:, lo], freqs[:, hi]
    env_f = f_lo + frac[None, :, None] * (f_hi - f_lo)
    env_a = torch.where(env_f >= nyquist, torch.zeros_like(env_a), env_a)

    omega = env_f * float(np.float32(2.0 * math.pi / sample_rate))
    if phase_dtype == torch.float64:
        phase = torch.cumsum(omega, dim=1, dtype=torch.float64).to(torch.float32)
    else:
        phase = float32_prefix(omega)
    terms = env_a * torch.sin(phase)
    audio = torch.zeros((batch, n_samples), dtype=torch.float32, device=dev)
    for j in range(k):
        audio = audio + terms[..., j]
    return audio
