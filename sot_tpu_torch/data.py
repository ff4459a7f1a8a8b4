"""Synthetic harmonic-sinusoid clips (L7), port of ``sot_tpu/data.py``.

  * random f0 in [freq_gen_min, freq_gen_max] Hz, amplitudes in
    [amplitude_min, amplitude_max], random active-harmonic count >= 1 with
    sequential or random masking — the same ``np.random.default_rng`` draws,
    in the same order, as the reference
  * signals rendered by the frozen Sinusoidal synth on the chosen device
    (the CUDA synth kernel on the card), 16 constant control frames
  * per-item peak normalisation x0.9
  * train/val/test random split (70/20/10), sequential peak-normalised
    batches

The training loop keeps a split resident on the device and slices batches
by offset (``training/trainer.train_steps``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from sot_tpu_torch.device import DeviceLike, resolve_device
from sot_tpu_torch.models.synths import Sinusoidal


@dataclasses.dataclass
class SplitArrays:
    """One split: signals plus ground-truth params (metrics only, never loss)."""

    x: np.ndarray          # [n, n_samples]
    frequency: np.ndarray  # [n, n_freqs]
    weights: np.ndarray    # [n, n_sinusoids]

    def __len__(self) -> int:
        return len(self.x)


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


def random_split(signals: np.ndarray, freqs: np.ndarray, amplitudes: np.ndarray,
                 eval_split: float = 0.2, test_split: Optional[float] = 0.1,
                 seed: int = 0) -> Dict[str, SplitArrays]:
    """Random train/val(/test) split."""
    size = len(signals)
    perm = np.random.default_rng(seed).permutation(size)
    n_test = int(test_split * size) if test_split is not None else 0
    n_val = int(eval_split * size)
    n_train = int((1 - eval_split - (test_split or 0.0)) * size)

    def take(idx):
        return SplitArrays(signals[idx], freqs[idx], amplitudes[idx])

    splits = {"train": take(perm[:n_train]), "val": take(perm[n_train:n_train + n_val])}
    if test_split is not None:
        splits["test"] = take(perm[n_train + n_val:n_train + n_val + n_test])
    return splits


def make_dataset(seed: int = 0, device: DeviceLike = None, **kwargs) -> Dict[str, SplitArrays]:
    signals, freqs, amps = generate_sinusoid_dataset(seed=seed, device=device, **kwargs)
    return random_split(signals, freqs, amps, seed=seed)


def dataset_from_config(cfg, device: DeviceLike = None) -> Dict[str, SplitArrays]:
    """Splits for an ExperimentConfig: the released ``.pth`` dataset if
    ``cfg.dataset_path`` is set, else generated with the config's full
    generation parameters."""
    if cfg.dataset_path:
        return load_pth_dataset(cfg.dataset_path)
    return make_dataset(
        seed=cfg.data_seed, device=device, freq_gen_min=cfg.freq_gen_min,
        freq_gen_max=cfg.freq_gen_max, n_samples=cfg.n_samples,
        sample_rate=cfg.sample_rate, amplitude_min=cfg.amplitude_min,
        amplitude_max=cfg.amplitude_max, size=cfg.dataset_size,
        n_sinusoids=cfg.n_sinusoids, n_sinusoids_min=cfg.n_sinusoids_min,
        mask_rand_amplitudes=cfg.mask_rand_amplitudes)


def load_pth_dataset(path: str) -> Dict[str, SplitArrays]:
    """The reference's released torch dataset (e.g.
    ``40_1950_4096_04_1_4000_8_1_harmonic.pth``): a dict of
    ``{train,val[,test]}_tensors`` and ``{...}_thetas`` with ``frequency``
    and ``weights``. Only tensors and containers are unpickled
    (``weights_only``)."""
    d = torch.load(path, map_location="cpu", weights_only=True)

    def conv(tensors, thetas) -> SplitArrays:
        return SplitArrays(x=np.asarray(tensors, np.float32),
                           frequency=np.asarray(thetas["frequency"], np.float32),
                           weights=np.asarray(thetas["weights"], np.float32))

    out = {"train": conv(d["train_tensors"], d["train_thetas"]),
           "val": conv(d["val_tensors"], d["val_thetas"])}
    if "test_tensors" in d:
        out["test"] = conv(d["test_tensors"], d["test_thetas"])
    return out


def iterate_batches(split: SplitArrays, batch_size: int,
                    drop_last: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Sequential batches with peak-normalised signals (no per-epoch shuffle)."""
    n = len(split)
    stop = n - (n % batch_size) if drop_last else n
    for start in range(0, stop, batch_size):
        end = min(start + batch_size, n)
        yield {"x": peak_normalize(split.x[start:end]),
               "frequency": split.frequency[start:end],
               "weights": split.weights[start:end]}
