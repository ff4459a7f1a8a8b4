"""Synthetic harmonic-sinusoid clips (L7), port of ``sot_tpu/data.py``.

  * random f0 in [freq_gen_min, freq_gen_max] Hz, amplitudes in
    [amplitude_min, amplitude_max], random active-harmonic count >= 1 with
    sequential or random masking — the same ``np.random.default_rng`` draws,
    in the same order, as the reference
  * signals rendered by the frozen Sinusoidal synth on the chosen device
    (the CUDA synth kernel on the card), 16 constant control frames
  * per-item peak normalisation x0.9
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sot_tpu_torch.device import DeviceLike, resolve_device
from sot_tpu_torch.models.synths import Sinusoidal


def peak_normalize(x: np.ndarray, scale: float = 0.9) -> np.ndarray:
    """Per-item peak normalisation."""
    peak = np.abs(x).max(axis=-1, keepdims=True)
    return x / (peak + 1e-7) * scale


def generate_sinusoid_dataset(
    seed: int = 0,
    freq_gen_min: float = 40.0,
    freq_gen_max: float = 1950.0,
    n_samples: int = 4096,
    sample_rate: int = 16000,
    amplitude_min: float = 0.4,
    amplitude_max: float = 1.0,
    size: int = 4000,
    n_sinusoids: int = 8,
    n_sinusoids_min: Optional[int] = 1,
    mask_rand_amplitudes: bool = False,
    harmonic: bool = True,
    n_fake_frames: int = 16,
    render_batch: int = 500,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate (signals, freqs, amplitudes) with the paper's distribution.

    Returns raw (un-normalised) float32 numpy arrays. Renders on ``device``
    (default: the GPU; raises if there is none).
    """
    device = resolve_device(device)
    if freq_gen_max >= sample_rate / 2:
        raise ValueError("freq_gen_max must be less than sample_rate / 2")

    rng = np.random.default_rng(seed)
    n_freqs = 1 if harmonic else n_sinusoids
    freqs = rng.uniform(freq_gen_min, freq_gen_max, (size, n_freqs)).astype(np.float32)
    amplitudes = rng.uniform(amplitude_min, amplitude_max,
                             (size, n_sinusoids)).astype(np.float32)

    if n_sinusoids_min is not None:
        n_active = rng.integers(n_sinusoids_min - 1, n_sinusoids, size=size)
        if mask_rand_amplitudes:
            mask = np.zeros((size, n_sinusoids - 1), bool)
            for i in range(size):
                mask[i, rng.permutation(n_sinusoids - 1)[: n_active[i]]] = True
        else:
            mask = np.arange(1, n_sinusoids)[None, :] < n_active[:, None]
        mask = np.concatenate([np.ones((size, 1), bool), mask], axis=1)
        amplitudes = amplitudes * mask.astype(np.float32)

    synth = Sinusoidal(n_samples=n_samples, sample_rate=sample_rate,
                       amp_scale_fn=None, freq_scale_fn=None, harmonic=harmonic)

    signals = np.empty((size, n_samples), np.float32)
    with torch.inference_mode():
        for start in range(0, size, render_batch):
            end = min(start + render_batch, size)
            a = np.repeat(amplitudes[start:end, None, :], n_fake_frames, axis=1)
            f = np.repeat(freqs[start:end, None, :], n_fake_frames, axis=1)
            if not harmonic:
                a = a / a.sum(axis=-1, keepdims=True)
            out = synth(torch.from_numpy(a).to(device), torch.from_numpy(f).to(device))
            signals[start:end] = out.cpu().numpy()
    return signals, freqs, amplitudes
