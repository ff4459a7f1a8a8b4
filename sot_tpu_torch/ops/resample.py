"""Frame-rate -> sample-rate control upsampling (``sot_tpu/ops/resample.py``).

Methods, as the synth uses them:
  * 'window'   — hann overlap-add upsampling for amplitude envelopes: with
                 50% overlapping windows the OLA is one reshape + one add.
  * 'bilinear' — ``F.interpolate`` parity (align_corners = not add_endpoint)
                 for frequency envelopes.
  * 'bicubic'  — ``F.interpolate`` parity (Keys, a = -0.75, edge taps
                 clamped), as one constant [n_timesteps, n_frames] matrix
                 built in float64 and applied in f32.
  * 'nearest'  — the JAX package's truncating index floor(t * n_frames /
                 n_timesteps), not torch's 'nearest' mode.

'window' and 'bilinear' keep the reference's exact expressions —
``a_{j+1}*w_rise + a_j*w_fall`` and ``x_lo + frac*(x_hi - x_lo)`` with
``frac`` computed in float64 on the host — because the synth kernel must
reproduce these envelopes bit for bit (PERF.md, "The synth-kernel lesson").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sot_tpu_torch.device import device_constant
from sot_tpu_torch.ops.windows import hann_window


def upsample_with_windows(inputs: torch.Tensor, n_timesteps: int,
                          add_endpoint: bool = True) -> torch.Tensor:
    """Hann-window overlap-add upsample of [batch, n_frames, ch] to n_timesteps.

    out_chunk[j] = a[j+1] * w[:hop] + a[j] * w[hop:], j = 0..n_intervals-1.
    """
    inputs = inputs.to(torch.float32)
    if inputs.ndim != 3:
        raise ValueError(f"upsample_with_windows expects 3D input, got {tuple(inputs.shape)}")
    if add_endpoint:
        inputs = torch.cat([inputs, inputs[:, -1:, :]], dim=1)

    n_frames = inputs.shape[1]
    n_intervals = n_frames - 1
    if n_frames >= n_timesteps:
        raise ValueError(
            f"Upsample with windows cannot be used for downsampling "
            f"(frames={n_frames}, timesteps={n_timesteps})")
    if n_timesteps % n_intervals != 0:
        raise ValueError(
            f"n_timesteps ({n_timesteps}) must be divisible by n_intervals ({n_intervals})")

    hop_size = n_timesteps // n_intervals
    window = device_constant(hann_window(2 * hop_size), inputs.device)

    windowed = inputs[:, :, None, :] * window[None, None, :, None]
    first = windowed[:, :, :hop_size, :]
    second = windowed[:, :, hop_size:, :]
    chunks = first[:, 1:, :, :] + second[:, :-1, :, :]
    batch, _, _, ch = chunks.shape
    return chunks.reshape(batch, n_timesteps, ch)


def linear_taps(n_frames: int, n_timesteps: int, align_corners: bool
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, frac) of 1D linear interpolation, torch F.interpolate parity.

    ``frac`` is computed in float64 and rounded once to float32. The tail
    rows are clipped to lo = n-2, frac = 1.0 (not lo = n-1, frac = 0), which
    the envelope's bits depend on.
    """
    if align_corners:
        coords = np.linspace(0.0, n_frames - 1, n_timesteps, dtype=np.float64)
    else:
        scale = n_frames / n_timesteps
        coords = (np.arange(n_timesteps, dtype=np.float64) + 0.5) * scale - 0.5
        coords = np.clip(coords, 0.0, n_frames - 1)
    lo = np.floor(coords).astype(np.int64)
    lo = np.minimum(lo, n_frames - 2) if n_frames > 1 else np.zeros_like(lo)
    frac = (coords - lo).astype(np.float32)
    hi = np.minimum(lo + 1, n_frames - 1)
    return lo, hi, frac


def _interp_linear(inputs: torch.Tensor, n_timesteps: int,
                   align_corners: bool) -> torch.Tensor:
    """1D linear interpolation along axis 1."""
    lo, hi, frac = linear_taps(inputs.shape[1], n_timesteps, align_corners)
    dev = inputs.device
    frac_t = device_constant(frac, dev)[None, :, None]
    x_lo = inputs[:, device_constant(lo, dev), :]
    x_hi = inputs[:, device_constant(hi, dev), :]
    return x_lo + frac_t * (x_hi - x_lo)


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution weights, torch's a = -0.75 variant."""
    at = np.abs(t)
    w1 = (a + 2.0) * at ** 3 - (a + 3.0) * at ** 2 + 1.0          # |t| <= 1
    w2 = a * at ** 3 - 5.0 * a * at ** 2 + 8.0 * a * at - 4.0 * a  # 1 < |t| < 2
    return np.where(at <= 1.0, w1, np.where(at < 2.0, w2, 0.0))


def cubic_matrix(n_frames: int, n_timesteps: int, align_corners: bool) -> np.ndarray:
    """The [n_timesteps, n_frames] float64 matrix of 1D bicubic
    interpolation: the source coordinate is not clamped, each of the 4 taps
    clamps its index to [0, n_frames - 1] (edge replication)."""
    if align_corners and n_frames > 1:
        coords = np.linspace(0.0, n_frames - 1, n_timesteps, dtype=np.float64)
    elif align_corners:
        coords = np.zeros(n_timesteps, dtype=np.float64)
    else:
        scale = n_frames / n_timesteps
        coords = (np.arange(n_timesteps, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(coords).astype(np.int64)
    frac = coords - lo
    mat = np.zeros((n_timesteps, n_frames), dtype=np.float64)
    for k in range(-1, 3):
        np.add.at(mat, (np.arange(n_timesteps), np.clip(lo + k, 0, n_frames - 1)),
                  _cubic_kernel(frac - k))
    return mat


def _interp_cubic(inputs: torch.Tensor, n_timesteps: int,
                  align_corners: bool) -> torch.Tensor:
    """1D bicubic interpolation along axis 1: ``cubic_matrix`` rounded once
    to f32, made on the device once per shape, applied as one matmul."""
    n_frames = inputs.shape[1]
    mat = device_constant(cubic_matrix(n_frames, n_timesteps, align_corners).astype(np.float32),
                          inputs.device, key=("cubic", n_frames, n_timesteps, align_corners))
    return torch.einsum("tf,bfc->btc", mat, inputs)


def _interp_nearest(inputs: torch.Tensor, n_timesteps: int) -> torch.Tensor:
    """Sample t takes frame floor(t * n_frames / n_timesteps) (clipped)."""
    n_frames = inputs.shape[1]
    scale = n_frames / n_timesteps
    idx = np.minimum((np.arange(n_timesteps) * scale).astype(np.int64), n_frames - 1)
    return inputs[:, device_constant(idx, inputs.device), :]


def resample(inputs: torch.Tensor, n_timesteps: int, method: str = "bilinear",
             add_endpoint: bool = True) -> torch.Tensor:
    """Resample framewise controls to n_timesteps.

    Accepts [n_frames], [batch, n_frames] or [batch, n_frames, ch]; returns
    the same rank at the new time resolution.
    """
    inputs = inputs.to(torch.float32)
    is_1d, is_2d = inputs.ndim == 1, inputs.ndim == 2
    if is_1d:
        inputs = inputs[None, :, None]
    elif is_2d:
        inputs = inputs[:, :, None]

    if method == "window":
        outputs = upsample_with_windows(inputs, n_timesteps, add_endpoint)
    elif method == "bilinear":
        outputs = _interp_linear(inputs, n_timesteps, align_corners=not add_endpoint)
    elif method == "bicubic":
        outputs = _interp_cubic(inputs, n_timesteps, align_corners=not add_endpoint)
    elif method == "nearest":
        outputs = _interp_nearest(inputs, n_timesteps)
    else:
        raise ValueError(
            f"Method ({method}) is invalid. Must be one of "
            f"['nearest', 'bilinear', 'bicubic', 'window'].")

    if is_1d:
        return outputs[0, :, 0]
    if is_2d:
        return outputs[:, :, 0]
    return outputs
