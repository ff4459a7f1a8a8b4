"""Device resolution and the float32 precision policy.

Entry points (``predict``, ``generate_sinusoid_dataset``, the CLI) run on
CUDA unless the caller asks for the CPU; with no GPU and no explicit device
they raise instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU; raise if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def set_precision_policy() -> None:
    """Full float32 on the card: no TF32 in matmuls or cuDNN convolutions.

    PyTorch's defaults leave cuDNN convolutions in TF32 (about three decimal
    digits); the port's parity with the JAX reference is stated in f32, so
    both switches are pinned off. Lower-precision variants (bf16 CQT
    operands, bf16 conv activations) are separate decisions, each gated on
    a training verdict.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

