"""The kernel gates as explicit arguments (``sot_tpu``'s env gates, one field each).

The JAX package turns its alternative kernels on with environment variables
read at trace time (``sot_tpu/kernel_gates.py``, ``ops/pallas/sot.py:
_merge_mode``, ``ops/stft.py``, ``models/encoder.py``). The port reads no
environment variable: a ``KernelGates`` is passed to ``build_modules``,
``Wasserstein1D``, ``features.STFT`` and ``MSSLoss`` (each also takes a
preset name).

Presets:
  * ``"default"`` — every gate off: the SOT loss on the banded plane
    (``plane``), PyTorch's convolutions and FFT
  * ``"auto"`` — the SOT routes that ``cli train --kernels auto`` ships:
    ``ref`` above 512 bins, ``hybrid`` at or below (the committed A/Bs
    written out), the rest off. It differs from the JAX package's shipped
    recipe (``sot_tpu.kernel_gates.auto_gates()``) in one gate:
    ``conv_bf16`` stays off. JAX turns ``SOT_TPU_CONV_BF16`` on after its
    own 25k-step TPU verdict; the port needs an H100 verdict first. (The
    CQT and synth kernels, gates in the JAX package, always run here.)

Not mirrored: ``SOT_TPU_MERGE_ROWS`` and ``SOT_TPU_CONV_ROWS`` (TPU row
tiles, which mean nothing to the CUDA kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

W2_MODES = ("off", "full", "hybrid", "ref")


@dataclasses.dataclass(frozen=True)
class KernelGates:
    w2_merge: str = "off"
    """``SOT_TPU_W2_MERGE``: the same-grid W_2 route. ``off`` (the banded
    plane), ``full`` (merge-coupling value and its min-halving gradient,
    kernels B4 + B8), ``hybrid`` (B4 + the plane backward B7) or ``ref``
    (B4 + the plane-convention rank backward B5)."""
    w2_merge_small: str = ""
    """``SOT_TPU_W2_MERGE_SMALL``: a mode that overrides ``w2_merge`` for
    rows of at most 512 bins (``SOT_TPU_W2_SMALL_N``'s default); ``""`` for
    none."""
    conv: bool = False
    """``SOT_TPU_CONV_PALLAS``: the encoder's k > 1 'same' convolutions on
    the hand-written kernels B10 (forward and dx) and B11 (dW)."""
    conv_dtype: torch.dtype = torch.bfloat16
    """``SOT_TPU_CONV_DTYPE``: the operand type of those kernels (f32
    accumulation); bf16 as in the JAX package, float32 for exact parity."""
    conv_bf16: bool = False
    """``SOT_TPU_CONV_BF16``: the encoder's conv stack in bf16, as Flax's
    ``nn.Conv(dtype=bfloat16)`` computes it: input, weight and bias cast to
    bf16, the conv with a bf16 output, the bias added after it in bf16, and
    the leaky-ReLUs, the residual add and dropout in bf16, back to f32
    after ``conv4b``. With ``conv`` as well, the k > 1 convs stay on kernels
    B10/B11 with f32 outputs and only the 1x1 convs go bf16 (the JAX
    package's precedence). Off in both presets until an H100 training
    verdict."""
    stft_frontend: bool = False
    """``SOT_TPU_STFT_PALLAS``: the fused pad_end framing + window + real-DFT
    projection (kernel B9) for STFTs whose hop is a multiple of 128 and
    divides both the signal length and the FFT size."""
    dft_matmul: bool = False
    """``SOT_TPU_DFT_MATMUL``: |rfft| of the framed, windowed signal as one
    f32 matmul (TF32 off) against the real-DFT matrix for n_fft <= 4096, in
    place of the FFT, in the loss transform and the MSS loss (where
    ``stft_frontend`` does not take the STFT). A matrix product outside any
    Pallas kernel in the JAX package, so ``torch.matmul`` here."""

    def __post_init__(self):
        if self.w2_merge not in W2_MODES:
            raise ValueError(f"w2_merge must be one of {W2_MODES}, got {self.w2_merge!r}")
        if self.w2_merge_small not in ("",) + W2_MODES:
            raise ValueError(f"w2_merge_small must be '' or one of {W2_MODES}, "
                             f"got {self.w2_merge_small!r}")
        if not isinstance(self.conv_bf16, bool):
            raise ValueError(f"conv_bf16 must be a bool, got {self.conv_bf16!r}")
        if self.conv_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"conv_dtype must be torch.bfloat16 or torch.float32, "
                             f"got {self.conv_dtype}")


PRESETS = {
    "default": KernelGates(),
    "auto": KernelGates(w2_merge="ref", w2_merge_small="hybrid"),
}

Kernels = Union[str, KernelGates]


def resolve_gates(kernels: Kernels) -> KernelGates:
    """A ``KernelGates`` as it is, or the preset of that name."""
    if isinstance(kernels, KernelGates):
        return kernels
    if kernels in PRESETS:
        return PRESETS[kernels]
    raise ValueError(f"kernels must be a KernelGates or one of {sorted(PRESETS)}, "
                     f"got {kernels!r}")
