"""Complex magnitude with a zero-safe gradient (``sot_tpu/ops/stft.py:36-49``).

Only ``_complex_abs`` is ported in this slice; the loss-domain STFT comes
with the training slice.
"""

from __future__ import annotations

import torch


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

