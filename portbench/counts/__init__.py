"""Operations and bytes from shapes, and the peaks they are held to. What a
model's work needs is counted in ``counts/<model>.py`` (the model a
configuration file names under ``"model"``), from these helpers.

Peaks: NVIDIA H100 SXM data sheet, dense. The configurations compute in
float32, and the highest rate at which the card takes float32 operands is
TF32's 495 TFLOP/s, so no route that passes the comparison can exceed it
(cuDNN's f32, the 3xTF32 kernels); HBM3 at 3.35 TB/s. The card's power
limit is written beside every number kept (PERF.md).

Operations count a multiply-add as two. Bytes count each input read once
and each output written once, in float32.
"""

from __future__ import annotations

from types import ModuleType

PEAK_FLOPS = 495e12  # TF32 dense
PEAK_BYTES = 3.35e12  # HBM3
F32 = 4


def of(cfg: dict) -> ModuleType:
    """The counts of the model that the configuration ``cfg`` names."""
    from portbench import spec

    return spec.load_part("counts", spec.model_name(cfg))


def conv_flops(c_in: int, c_out: int, k: int, length: int, rows: int) -> float:
    """One 'same' convolution's forward (dx and dw are each as many)."""
    return 2.0 * c_in * c_out * k * length * rows


def conv_bytes(c_in: int, c_out: int, k: int, length: int, rows: int, pass_: str) -> float:
    """fwd: x and w in, y out; dx: dy and w in, dx out; dw: x and dy in, dw out."""
    x, y, w = rows * c_in * length, rows * c_out * length, c_in * c_out * k
    return F32 * {"fwd": x + w + y, "dx": y + w + x, "dw": x + y + w}[pass_]


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
