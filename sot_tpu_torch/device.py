"""Device resolution and the float32 precision policy.

Entry points (``predict``, ``generate_sinusoid_dataset``, the CLI) run on
CUDA unless the caller asks for the CPU; with no GPU and no explicit device
they raise instead of quietly running on the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Any, Dict, Hashable, Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

_CONSTANTS: Dict[Hashable, torch.Tensor] = {}


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


def card_line(device: DeviceLike) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; "cpu" for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0].strip()


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



def device_constant(array: np.ndarray, device: DeviceLike,
                    key: Optional[Hashable] = None,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``array`` as a tensor on ``device`` (cast to ``dtype`` if given, for a
    type numpy lacks such as bfloat16), made at the first call and kept for
    good: later calls with the same values (or the same ``key``, for a large
    table whose bytes are costly to hash) get the same tensor.

    A host-to-device copy cannot be captured into a CUDA graph, and a
    captured step reads its constants at fixed addresses, so every host
    constant of the train and eval steps comes through here: made once
    (by the warm-up before a capture), never copied again and never freed.
    The values are the array's, bit for bit; callers must not write to it.
    """
    dev = torch.device(device)
    a: Any = np.ascontiguousarray(array)
    full_key = (("key", key) if key is not None
                else ("array", a.dtype.str, a.shape, a.tobytes()), str(dtype), str(dev))
    t = _CONSTANTS.get(full_key)
    if t is None:
        # a normal tensor even when first asked for under inference_mode,
        # so autograd can save it later
        with torch.inference_mode(False):
            t = _CONSTANTS[full_key] = torch.from_numpy(a.copy()).to(dtype=dtype).to(dev)
    return t
