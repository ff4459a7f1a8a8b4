"""L0 numeric utilities: safe math, pitch-scale maps, nonlinearities.

Port of ``sot_tpu/ops/numerics.py`` with the same conventions:
  * ``safe_divide``  — eps = 1e-7, denominator <= eps is replaced by eps
  * ``safe_log``     — eps = 1e-5, x <= eps is replaced by eps
  * hz <-> midi <-> unit maps, float32 throughout
  * ``exp_sigmoid``  — max_value * sigmoid(x)**log(exponent) + threshold

Scalars (python floats) are promoted to 0-dim float32 tensors so the maps
round exactly where the reference's float32 arithmetic rounds.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Union

import torch

Number = Union[float, torch.Tensor]


def _f32(x: Number) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def safe_divide(numerator: Number, denominator: Number, eps: float = 1e-7) -> torch.Tensor:
    denominator = torch.as_tensor(denominator)
    safe = torch.where(denominator <= eps,
                       torch.full_like(denominator, eps), denominator)
    return numerator / safe


def safe_log(x: Number, eps: float = 1e-5) -> torch.Tensor:
    x = torch.as_tensor(x)
    return torch.log(torch.where(x <= eps, torch.full_like(x, eps), x))


def safe_log10(x: Number, eps: float = 1e-5) -> torch.Tensor:
    x = torch.as_tensor(x)
    return torch.log10(torch.where(x <= eps, torch.full_like(x, eps), x))


def logb(x: Number, base: float = 2.0, safe: bool = False) -> torch.Tensor:
    x = _f32(x)
    if safe:
        return safe_divide(safe_log(x), math.log(base))
    return torch.log(x) / math.log(base)


def log10(x: Number) -> torch.Tensor:
    """Safe log base 10: ``safe_log`` over log(10), through ``safe_divide``
    as the JAX package takes it."""
    return logb(x, base=10.0, safe=True)


# ---------------------------------------------------------------------------
# Pitch scale maps (hz <-> midi <-> unit)
# ---------------------------------------------------------------------------


def hz_to_midi(frequencies: Number) -> torch.Tensor:
    """Hz -> MIDI; 0 Hz maps to MIDI 0."""
    frequencies = _f32(frequencies)
    # the 0-dim CPU constant enters a device op as a scalar: no copy to the
    # device (which a CUDA graph could not capture)
    notes = 12.0 * (logb(frequencies, 2.0) - logb(440.0, 2.0)) + 69.0
    return torch.where(frequencies <= 0.0, torch.zeros_like(notes), notes)


def midi_to_hz(notes: Number) -> torch.Tensor:
    notes = _f32(notes)
    return 440.0 * (2.0 ** ((notes - 69.0) / 12.0))


def unit_to_midi(unit: Number, midi_min: Number = 20.0, midi_max: Number = 90.0,
                 clip: bool = False) -> torch.Tensor:
    unit = _f32(unit)
    if clip:
        unit = torch.clamp(unit, 0.0, 1.0)
    midi_min, midi_max = _f32(midi_min), _f32(midi_max)
    return midi_min + (midi_max - midi_min) * unit


def midi_to_unit(midi: Number, midi_min: Number = 20.0, midi_max: Number = 90.0,
                 clip: bool = False) -> torch.Tensor:
    midi = _f32(midi)
    midi_min, midi_max = _f32(midi_min), _f32(midi_max)
    unit = (midi - midi_min) / (midi_max - midi_min)
    return torch.clamp(unit, 0.0, 1.0) if clip else unit


def unit_to_hz(unit: Number, hz_min: Number, hz_max: Number,
               clip: bool = False) -> torch.Tensor:
    """[0,1] -> [hz_min, hz_max] logarithmically."""
    midi = unit_to_midi(unit, midi_min=hz_to_midi(hz_min),
                        midi_max=hz_to_midi(hz_max), clip=clip)
    return midi_to_hz(midi)


def hz_to_unit(hz: Number, hz_min: Number = 20.0, hz_max: Number = 8000.0,
               clip: bool = False) -> torch.Tensor:
    """[hz_min, hz_max] -> [0,1] logarithmically."""
    return midi_to_unit(hz_to_midi(hz), midi_min=hz_to_midi(hz_min),
                        midi_max=hz_to_midi(hz_max), clip=clip)


# ---------------------------------------------------------------------------
# Nonlinearities
# ---------------------------------------------------------------------------


def exp_sigmoid(x: Number, exponent: float = 10.0, max_value: float = 2.0,
                threshold: float = 1e-7) -> torch.Tensor:
    """Exponentiated sigmoid, bounded to [threshold, max_value]."""
    x = _f32(x)
    return max_value * torch.sigmoid(x) ** math.log(exponent) + threshold


def frequencies_softmax(freqs: torch.Tensor, depth: int = 64, hz_min: float = 20.0,
                        hz_max: float = 8000.0) -> torch.Tensor:
    """Softmax over `depth` log-spaced bins per sinusoid -> Hz."""
    if freqs.ndim == 3:
        n_batch, n_time, n_combined = freqs.shape
        freqs = freqs.reshape(n_batch, n_time, n_combined // depth, depth)
    else:
        depth = freqs.shape[-1]
    f_probs = torch.softmax(freqs, dim=-1)
    unit_bins = torch.linspace(0.0, 1.0, depth, device=freqs.device)
    f_unit = torch.sum(unit_bins * f_probs, dim=-1)
    return unit_to_hz(f_unit, hz_min=hz_min, hz_max=hz_max)


def power_to_db(power: Number, ref_db: float = 0.0, range_db: float = 80.0) -> torch.Tensor:
    """Linear power -> dB with a dynamic-range floor: power clamped below at
    10^(-range_db / 10), 10 * ``log10``, minus ``ref_db``, clamped below at
    -range_db."""
    power = torch.clamp(_f32(power), min=10.0 ** -(range_db / 10.0))
    db = 10.0 * log10(power) - ref_db
    return torch.clamp(db, min=-range_db)


# ---------------------------------------------------------------------------
# Derived-config helpers
# ---------------------------------------------------------------------------


def get_cqt_n_bins(sr: int, fmin: float, bins_per_semitone: int = 3) -> int:
    """Number of CQT bins from fmin to Nyquist."""
    max_semitones = int(math.floor(12 * math.log2(sr / 2) - 12 * math.log2(fmin)))
    return max_semitones * bins_per_semitone


def pad_for_stft_length(signal_len: int, frame_size: int, hop_length: int) -> int:
    """Samples of right-padding for tf-style ``pad_end=True`` framing:
    num_frames = ceil(len / hop), padded so the last window fits."""
    num_frames = -(-signal_len // hop_length)
    return max(0, frame_size + hop_length * (num_frames - 1) - signal_len)


def get_fn_by_name(name: Optional[Union[str, Callable]], **kwargs) -> Optional[Callable]:
    """Scaling-function registry."""
    if callable(name):
        return name
    if name == "exp_sigmoid":
        return functools.partial(exp_sigmoid, **kwargs)
    if name == "frequencies_softmax":
        return functools.partial(frequencies_softmax, **kwargs)
    if name == "identity":
        return lambda x: x
    if name is None:
        return None
    raise ValueError(f"Unknown scaling function: {name}")
