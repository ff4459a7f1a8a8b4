"""'same' conv1d for the encoder's wide-kernel layers: hand-written CUDA
kernels and their plain versions.

Replaces the TPU kernels ``sot_tpu/ops/pallas/conv.py:_fwd_kernel`` (entry
``_conv_cmajor_fwd``; kernel B10) and ``_dw_kernel`` (entry
``_conv_cmajor_dw``; kernel B11), behind ``conv1d_same`` (``conv.py:192-232``).
The CUDA source is ``sot_tpu_torch/csrc/conv.cu``.

    y[b, co, w] = sum_{ci, d} W[co, ci, d] x[b, ci, w + d - p],  p = (k - 1) / 2

in PyTorch's NCW layout, which is already the TPU kernel's channel-major
layout (no transposes). The operands are rounded to ``dtype`` (bf16 by
default, round to nearest even) and multiplied and summed in f32, as the
TPU kernel casts them inside the kernel; ``dtype=torch.float32`` is plain
f32.

  * ``conv1d_same_plain`` / ``conv1d_weight_plain`` — ``F.conv1d`` and
    ``torch.nn.grad.conv1d_weight`` on the rounded operands
  * ``conv1d_forward`` (B10) / ``conv1d_weight`` (B11) — the wrappers: the
    plain version on a CPU tensor, the kernel on a CUDA tensor (or raise)
  * ``conv1d_same`` — the differentiable entry: forward B10; backward dx by
    B10 on dy with the tap-flipped, (ci <-> co)-transposed weight, and dW by
    B11, as the JAX package's custom VJP computes them

Bound on the H100: at the prefilter's shape (1024 rows, 40 -> 40, 285
bins, k = 15) 14.0 GFLOP each: 0.014 ms on the bf16 tensor cores, 0.085 ms
at the 3xTF32 rate, under the bytes (~93 MB in f32, 0.028 ms). Both kernels
are implicit GEMMs on the tensor cores (bf16 ``mma.sync``, or 3xTF32 for
float32 operands: f32 accuracy); see the source for the design. Their work
split comes from the shape and the card's SM count: ``fwd_blocks`` (B10's
persistent blocks over (row, strip) items) and ``dw_chunks`` (B11's split
over rows, summed in a fixed chunk order).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from sot_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernels (plain-version calls are not counted).
launches = 0     # B10: forwards and the dx of backwards
dw_launches = 0  # B11

MAX_K = 15    # odd k up to 15: each channel's taps padded to TAPS
TAPS = 16
MAX_CH = 40   # C_in and C_out
STRIP = 288   # bins per work item (csrc/conv.cu)


def round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (nearest even) and back to f32."""
    return t if dtype == torch.float32 else t.to(dtype).to(torch.float32)


def conv1d_same_plain(x: torch.Tensor, weight: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [B, C_in, W], weight [C_out, C_in, k] -> [B, C_out, W]."""
    k = weight.shape[-1]
    return F.conv1d(round_to(x, dtype), round_to(weight, dtype), padding=(k - 1) // 2)


def conv1d_weight_plain(x: torch.Tensor, dy: torch.Tensor, k: int,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """dW [C_out, C_in, k] of the 'same' conv from x [B, C_in, W] and dy
    [B, C_out, W]."""
    shape = (dy.shape[1], x.shape[1], k)
    return torch.nn.grad.conv1d_weight(round_to(x, dtype), shape, round_to(dy, dtype),
                                       padding=(k - 1) // 2)


def n_strips(width: int) -> int:
    """Work items per row: strips of STRIP bins."""
    return -(-width // STRIP)


def fwd_blocks(rows: int, width: int, n_sm: int) -> int:
    """B10's persistent blocks: one per SM (its shared memory holds one),
    never more than the (row, strip) items."""
    return min(rows * n_strips(width), n_sm)


def dw_chunks(rows: int, n_sm: int) -> Tuple[int, int]:
    """(rows per chunk, chunks) of B11's split over rows: at most one chunk
    per SM, each summed by one block."""
    per = -(-rows // n_sm)
    return per, -(-rows // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_shape(what: str, rows: int, cin: int, cout: int, width: int, k: int) -> None:
    if not (rows >= 1 and width >= 1 and 1 <= cin <= MAX_CH and 1 <= cout <= MAX_CH
            and k % 2 == 1 and 1 <= k <= MAX_K):
        raise ValueError(f"{what}: rows {rows}, C_in {cin}, C_out {cout}, width {width}, k {k}: "
                         f"the kernel takes C_in, C_out in [1, {MAX_CH}], an odd k <= {MAX_K} "
                         f"and non-empty rows")


def _bind() -> ctypes.CDLL:
    lib = _build.load("conv")
    fwd = lib.conv1d_same_fwd_f32
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    dw = lib.conv1d_same_dw_f32
    dw.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    dw.restype = ctypes.c_int
    return lib


def _check(what: str, x: torch.Tensor, other: torch.Tensor, dtype: torch.dtype) -> None:
    if x.device.type != "cuda" or other.device != x.device:
        raise ValueError(f"{what}: tensors on {x.device} / {other.device}")
    if x.dtype != torch.float32 or other.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32 tensors")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: operand type {dtype} is not bfloat16 or float32")
    if x.ndim != 3 or other.ndim != 3:
        raise ValueError(f"{what}: expected 3-d tensors, got {tuple(x.shape)} / "
                         f"{tuple(other.shape)}")


def conv1d_forward(x: torch.Tensor, weight: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel B10 (no autograd): x [B, C_in, W], weight [C_out, C_in, k]
    with k odd -> [B, C_out, W]."""
    if x.device.type == "cpu":
        return conv1d_same_plain(x, weight, dtype)
    _check("conv1d_forward", x, weight, dtype)
    rows, cin, width = x.shape
    cout, wcin, k = weight.shape
    if wcin != cin:
        raise ValueError(f"conv1d_forward: x {tuple(x.shape)}, weight {tuple(weight.shape)}: "
                         f"needs weight [C_out, C_in, k]")
    _check_shape("conv1d_forward", rows, cin, cout, width, k)
    x, weight = x.contiguous(), weight.contiguous()
    y = torch.empty((rows, cout, width), dtype=torch.float32, device=x.device)
    blocks = fwd_blocks(rows, width, _sm_count(x.device.index or 0))
    err = _bind().conv1d_same_fwd_f32(x.data_ptr(), weight.data_ptr(), y.data_ptr(), rows, cin,
                                      cout, width, k, blocks, int(dtype == torch.bfloat16),
                                      torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv1d_same_fwd_f32")
    global launches
    launches += 1
    return y


def conv1d_weight(x: torch.Tensor, dy: torch.Tensor, k: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel B11 (no autograd): dW [C_out, C_in, k] from x [B, C_in, W] and
    dy [B, C_out, W]."""
    if x.device.type == "cpu":
        return conv1d_weight_plain(x, dy, k, dtype)
    _check("conv1d_weight", x, dy, dtype)
    rows, cin, width = x.shape
    cout = dy.shape[1]
    if dy.shape != (rows, cout, width):
        raise ValueError(f"conv1d_weight: x {tuple(x.shape)}, dy {tuple(dy.shape)}, k {k}")
    _check_shape("conv1d_weight", rows, cin, cout, width, k)
    x, dy = x.contiguous(), dy.contiguous()
    per, chunks = dw_chunks(rows, _sm_count(x.device.index or 0))
    partial = torch.empty((chunks, cout * cin * k), dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, cin, k), dtype=torch.float32, device=x.device)
    err = _bind().conv1d_same_dw_f32(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                                     dw.data_ptr(), rows, cin, cout, width, k, per,
                                     int(dtype == torch.bfloat16),
                                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv1d_same_dw_f32")
    global dw_launches
    dw_launches += 1
    return dw


class _Conv1dSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, dtype):
        ctx.save_for_backward(x, weight)
        ctx.dtype = dtype
        return conv1d_forward(x, weight, dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the 'same' conv of dy with the tap-flipped, (ci <-> co)-transposed weight
            dx = conv1d_forward(dy, weight.flip(-1).transpose(0, 1), ctx.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv1d_weight(x, dy, weight.shape[-1], ctx.dtype)
        return dx, dw, None


def conv1d_same(x: torch.Tensor, weight: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Differentiable 'same' conv1d (no bias): x [B, C_in, W], weight
    [C_out, C_in, k] (PyTorch's layout), odd k -> [B, C_out, W]."""
    return _Conv1dSame.apply(x, weight, dtype)
