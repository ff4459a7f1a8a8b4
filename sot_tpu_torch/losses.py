"""Training losses (L4), port of ``sot_tpu/losses.py``: SOT (Wasserstein-1D)
and the multi-scale spectral loss.

  * ``Wasserstein1D`` — x (the target spectrum) self-normalised, y divided by
    x's mass under ``dont_normalize``; ``square_dist`` squares both first;
    ``limit_quantile_range`` is the frequency cutoff; ``kernels`` picks the
    same-grid route (where the JAX package reads its kernel gates); an
    optional hinge;
    [batch, frames, bins] rows flattened; mean over rows. One shared sorted
    numpy grid for both spectra takes the same-grid path (the training hot
    path), anything else the general sorting path.
  * ``MSSLoss`` — L1/L2 over linear and/or safe-log magnitudes at several
    FFT sizes (hann, 75% overlap).
  * ``MeanDifference`` (L1/L2, optionally of the sorted rows), ``KL``
    (between row-normalised spectra), ``Wasserstein1DWithTransform`` (its
    own STFT, then ``Wasserstein1D`` on rfft positions over their max) and
    ``MixOfLosses`` ({loss name: weighted value}).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from sot_tpu_torch.device import device_constant
from sot_tpu_torch.kernel_gates import Kernels, resolve_gates
from sot_tpu_torch.ops.numerics import safe_divide, safe_log
from sot_tpu_torch.ops.stft import stft_magnitude
from sot_tpu_torch.ops.wasserstein import wasserstein_1d, wasserstein_1d_same_grid


def mean_difference(target: torch.Tensor, value: torch.Tensor, loss_type: str = "L1",
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean L1/L2 difference."""
    difference = target - value
    w = 1.0 if weights is None else weights
    loss_type = loss_type.upper()
    if loss_type == "L1":
        return torch.mean(torch.abs(difference * w))
    if loss_type == "L2":
        return torch.mean(difference ** 2 * w)
    raise ValueError(f'Loss type ({loss_type}), must be "L1", "L2"')


@dataclasses.dataclass(frozen=True)
class MeanDifference:
    loss_type: str = "L1"

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 weights: Optional[torch.Tensor] = None, sort: bool = False,
                 **_kw) -> torch.Tensor:
        if sort:
            x = torch.sort(x, dim=-1).values
            y = torch.sort(y, dim=-1).values
        return mean_difference(x, y, loss_type=self.loss_type, weights=weights)


@dataclasses.dataclass(frozen=True)
class KL:
    """Mean over rows of KL(input || target) between the row-normalised
    spectra (``reverse`` swaps them), each log taken at value + eps."""

    eps: float = 1e-10
    reverse: bool = False

    def __call__(self, input: torch.Tensor, target: torch.Tensor, **_kw) -> torch.Tensor:
        original_shape = input.shape[:-1]
        if input.ndim == 3:
            input = input.reshape(-1, input.shape[-1])
        if target.ndim == 3:
            target = target.reshape(-1, target.shape[-1])
        if self.reverse:
            input, target = target, input
        input = safe_divide(input, torch.sum(input, dim=-1, keepdim=True))
        target = safe_divide(target, torch.sum(target, dim=-1, keepdim=True))
        kl = input * (torch.log(input + self.eps) - torch.log(target + self.eps))
        return torch.mean(torch.sum(kl, dim=-1).reshape(original_shape))


def _positions(pos, like: torch.Tensor) -> torch.Tensor:
    """Positions as f32 on ``like``'s device; host positions through
    ``device_constant`` (copied to the device once)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(dtype=torch.float32, device=like.device)
    return device_constant(np.asarray(pos, np.float32), like.device)


@dataclasses.dataclass(frozen=True)
class Wasserstein1D:
    """Spectral-optimal-transport loss. ``log_scaled_x`` is a marker read by
    the trainer (which log-maps the positions itself)."""

    p: float = 1
    fixed_x: Optional[int] = None
    require_sort: bool = True
    log_scaled_x: bool = False
    dont_normalize: bool = False
    limit_quantile_range: bool = False
    hinge: Union[bool, float] = False
    square_dist: bool = False
    # x (the target spectrum) is data with no gradient (training sets this)
    target_constant: bool = False
    # the same-grid W_2 route's gates: a KernelGates or a preset name
    # ("auto", "default"; ops/wasserstein.w2_route)
    kernels: Kernels = "auto"

    name = "Wasserstein1D"

    def normalize(self, x: torch.Tensor, y: torch.Tensor):
        """Weight rows [rows, n] of the two spectra: squared under
        ``square_dist``; x self-normalised; y by x's mass under
        ``dont_normalize``, else by its own."""
        if self.square_dist:
            x = x ** 2
            y = y ** 2
        total_mass_x = torch.sum(x, dim=1, keepdim=True)
        x = safe_divide(x, total_mass_x)
        if self.dont_normalize:
            y = safe_divide(y, total_mass_x)
        else:
            y = safe_divide(y, torch.sum(y, dim=1, keepdim=True))
        return x, y

    def __call__(self, x: torch.Tensor, y: torch.Tensor, x_pos=None, y_pos=None,
                 return_quantiles: bool = False, **kw):
        if (x_pos is None or y_pos is None) and self.fixed_x is None:
            raise ValueError("If fixed_x is not provided, x_pos and y_pos must be provided")
        if x_pos is None:
            x_pos = np.linspace(0.0, 1.0, self.fixed_x, dtype=np.float32)
        if y_pos is None:
            y_pos = np.linspace(0.0, 1.0, self.fixed_x, dtype=np.float32)

        original_shape = x.shape[:-1]
        if x.ndim == 3:
            x = x.reshape(-1, x.shape[-1])
        if y.ndim == 3:
            y = y.reshape(-1, y.shape[-1])
        # same-grid path: one shared 1D position vector, known on the host
        # and sorted (log-mapped positions can be non-monotone at bin 0)
        same_grid = (x_pos is y_pos and isinstance(x_pos, np.ndarray) and x_pos.ndim == 1
                     and bool(np.all(np.diff(x_pos) >= 0)))
        grid_1d = _positions(x_pos, x) if same_grid else None
        x_pos = _positions(x_pos, x)
        y_pos = _positions(y_pos, y)
        if x_pos.ndim == 3:
            x_pos = x_pos.reshape(-1, x_pos.shape[-1])
        if y_pos.ndim == 3:
            y_pos = y_pos.reshape(-1, y_pos.shape[-1])
        if x_pos.ndim == 1:
            x_pos = x_pos[None, :].expand(x.shape)
        if y_pos.ndim == 1:
            y_pos = y_pos[None, :].expand(y.shape)

        x, y = self.normalize(x, y)
        if same_grid and not return_quantiles:
            loss = wasserstein_1d_same_grid(
                grid_1d, x, y, p=self.p, limit_quantile_range=self.limit_quantile_range,
                target_constant=self.target_constant, kernels=self.kernels)
        else:
            loss = wasserstein_1d(x_pos, y_pos, u_weights=x, v_weights=y, p=self.p,
                                  require_sort=self.require_sort,
                                  return_quantiles=return_quantiles,
                                  limit_quantile_range=self.limit_quantile_range)
        if return_quantiles:
            return tuple(v.reshape(original_shape + (-1,)) for v in loss)
        if self.hinge:
            # the flag switches the hinge on; the threshold is a call kwarg
            loss = torch.relu(loss - float(kw.get("hinge", 0.0)))
        return torch.mean(loss.reshape(original_shape))


@dataclasses.dataclass(frozen=True)
class MSSLoss:
    """Multi-scale spectrogram loss, DDSP-style. ``kernels``: the
    ``stft_frontend`` gate sends the scales whose hop is a multiple of 128
    to kernel B9, the ``dft_matmul`` gate the others' |rfft| to one matmul."""

    fft_sizes: Tuple[int, ...] = (2048, 1024, 512, 256, 128, 64)
    loss_type: str = "L1"
    mag_weight: float = 0.0
    logmag_weight: float = 0.0
    kernels: Kernels = "auto"

    name = "MSSLoss"

    def __call__(self, target_audio: torch.Tensor, audio: torch.Tensor, **_kw) -> torch.Tensor:
        gates = resolve_gates(self.kernels)
        kw = {"frontend": gates.stft_frontend, "dft_matmul": gates.dft_matmul}
        loss = 0.0
        for size in self.fft_sizes:
            target_mag = stft_magnitude(target_audio, size=size, overlap=0.75, **kw)
            value_mag = stft_magnitude(audio, size=size, overlap=0.75, **kw)
            if self.mag_weight > 0:
                loss = loss + self.mag_weight * mean_difference(
                    target_mag, value_mag, self.loss_type)
            if self.logmag_weight > 0:
                loss = loss + self.logmag_weight * mean_difference(
                    safe_log(target_mag), safe_log(value_mag), self.loss_type)
        return loss


@dataclasses.dataclass(frozen=True)
class Wasserstein1DWithTransform:
    """``wasserstein`` on the magnitude STFTs of both signals (its own
    n_fft, hop and window), at the rfft frequencies over their max."""

    wasserstein: Wasserstein1D
    n_fft: int = 512
    hop_length: int = 128
    sample_rate: int = 16000
    window: Optional[str] = None

    name = "Wasserstein1DWithTransform"

    def __call__(self, x: torch.Tensor, y: torch.Tensor, **kw) -> torch.Tensor:
        overlap = 1.0 - self.hop_length / self.n_fft
        sx = stft_magnitude(x, size=self.n_fft, overlap=overlap, window=self.window)
        sy = stft_magnitude(y, size=self.n_fft, overlap=overlap, window=self.window)
        freqs = np.fft.rfftfreq(self.n_fft, d=1.0 / self.sample_rate).astype(np.float32)
        pos = freqs / freqs.max()  # one numpy grid: the same-grid path
        kw.pop("x_pos", None)
        kw.pop("y_pos", None)
        return self.wasserstein(sx, sy, x_pos=pos, y_pos=pos, **kw)


@dataclasses.dataclass(frozen=True)
class MixOfLosses:
    """Each loss of ``losses`` on the same inputs times its weight, keyed by
    the loss's class name."""

    losses: Tuple[object, ...]
    weights: Tuple[float, ...]

    def __call__(self, x: torch.Tensor, y: torch.Tensor, **kw) -> Dict[str, torch.Tensor]:
        return {type(fn).__name__: fn(x, y, **kw) * weight
                for fn, weight in zip(self.losses, self.weights)}
