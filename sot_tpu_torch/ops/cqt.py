"""Constant-Q transform as a precomputed kernel-bank projection
(``sot_tpu/ops/cqt.py``).

Semantics (librosa/nnAudio CQT1992v2 parity, as in the reference):
  * Q = filter_scale / (2^(1/bins_per_octave) - 1)
  * bin frequencies f_k = fmin * 2^(k / bins_per_octave)
  * kernel k: hann(l_k) * exp(2*pi*i*f_k*t/fs) / l_k with l_k = ceil(Q*fs/f_k),
    centred in a power-of-2 width, L1-normalised, scaled by sqrt(l_k)
  * center=True pads kernel_width//2 zeros each side; frames advance by hop
  * output magnitude |CQT| with a zero-safe gradient

The bank is built once with numpy (cached per parameter tuple) and moved to
each device once (cached per device), as ``[k_real | k_imag | 0]`` of
2*n_bins columns zero-padded to a multiple of 128. The projection goes
through ``ops.kernels.cqt.cqt_project``: the CUDA kernel on the card, the
plain unfold + matmul on the CPU.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sot_tpu_torch.ops.kernels.cqt import cqt_project
from sot_tpu_torch.ops.stft import _complex_abs

_COL_ALIGN = 128


@functools.lru_cache(maxsize=8)
def build_cqt_kernels(
    sr: int,
    fmin: float,
    n_bins: int,
    bins_per_octave: int,
    filter_scale: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, np.ndarray]:
    """Build the complex CQT kernel bank.

    Returns (kernels_real, kernels_imag, frequencies, kernel_width, lengths)
    where kernels_* have shape [kernel_width, n_bins] (matmul-ready) and
    already include the librosa-style sqrt(l_k) output scaling.
    """
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    if np.max(freqs) > sr / 2.0:
        raise ValueError(
            f"The top bin {np.max(freqs):.1f} Hz exceeds the Nyquist frequency; "
            f"reduce n_bins.")
    max_len = int(np.ceil(q * sr / fmin))
    kernel_width = int(2 ** math.ceil(math.log2(max_len)))

    kernels = np.zeros((n_bins, kernel_width), dtype=np.complex64)
    for k in range(n_bins):
        f = freqs[k]
        l = int(np.ceil(q * sr / f))
        # centre the support; odd lengths sit one sample earlier
        start = int(np.ceil(kernel_width / 2.0 - l / 2.0)) - (l % 2)
        n = np.arange(-(l // 2), l - (l // 2))
        window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(l) / l)  # periodic hann
        sig = window * np.exp(2j * np.pi * f * n / sr) / l
        sig = sig / np.linalg.norm(sig, 1)
        kernels[k, start:start + l] = sig * np.sqrt(l)

    k_real = np.ascontiguousarray(kernels.real.T.astype(np.float32))
    # conv correlation with the imaginary part is negated in CQT1992v2
    k_imag = np.ascontiguousarray((-kernels.imag.T).astype(np.float32))
    lengths = np.ceil(q * sr / freqs).astype(np.int64)
    return k_real, k_imag, freqs.astype(np.float32), kernel_width, lengths


@functools.lru_cache(maxsize=4)
def cqt_bank(sr: int, fmin: float, n_bins: int, bins_per_octave: int,
             filter_scale: float, device: torch.device) -> torch.Tensor:
    """[kernel_width, ldb] f32 bank on ``device``: columns [k_real | k_imag],
    then zeros up to ldb = 2*n_bins rounded up to a multiple of 128."""
    k_real, k_imag, _, width, _ = build_cqt_kernels(sr, fmin, n_bins,
                                                    bins_per_octave, filter_scale)
    ldb = -(-2 * n_bins // _COL_ALIGN) * _COL_ALIGN
    bank = np.zeros((width, ldb), np.float32)
    bank[:, :n_bins] = k_real
    bank[:, n_bins:2 * n_bins] = k_imag
    return torch.from_numpy(bank).to(device)


def cqt_magnitude(
    audio: torch.Tensor,
    sr: int = 16000,
    fmin: float = 32.7,
    n_bins: int = 285,
    bins_per_octave: int = 36,
    hop_length: int = 256,
    filter_scale: float = 1.0,
    center: bool = True,
) -> torch.Tensor:
    """|CQT| of [batch, T] audio -> [batch, n_frames, n_bins] (time-major).

    n_frames = floor(T / hop_length) + 1 with center=True.
    """
    audio = audio.to(torch.float32)
    bank = cqt_bank(sr, fmin, n_bins, bins_per_octave, filter_scale, audio.device)
    kernel_width = bank.shape[0]
    if center:
        pad = kernel_width // 2
        audio = F.pad(audio, (pad, pad))
    audio = audio.contiguous()
    n_frames = (audio.shape[-1] - kernel_width) // hop_length + 1
    proj = cqt_project(audio, bank, hop_length, n_frames, 2 * n_bins)
    return _complex_abs(proj[..., :n_bins], proj[..., n_bins:])


def cqt_frequencies(sr: int = 16000, fmin: float = 32.7, n_bins: int = 285,
                    bins_per_octave: int = 36) -> np.ndarray:
    return (fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)).astype(np.float32)
