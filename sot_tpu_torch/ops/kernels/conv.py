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

The f32 route (``csrc/conv_f32.cu``; no TPU kernel, it takes the place of
cuDNN's f32 convolutions on the default route) computes the same
convolution in f32 on the CUDA cores, products by FFMA, summed in f32:

  * ``conv1d_f32_forward`` — the forward with its bias (or, with
    ``transposed``, the input gradient: the weight read tap-flipped and
    (ci <-> co)-transposed in place); plain version ``F.conv1d``
  * ``conv1d_f32_weight`` — dW, split over (row, strip) items, a run of
    them per block, the blocks summed in a fixed order; plain version
    ``torch.nn.grad.conv1d_weight``
  * ``conv1d_f32`` — the differentiable entry (the bias gradient is
    ``dy.sum((0, 2))``, as PyTorch's convolution backward takes it)
  * ``f32_route`` — the shape rule that gives a layer to these kernels

Bound on the H100 at the prefilter's shape: 14.0 GFLOP a pass, 0.209 ms at
the FP32 peak (67 TFLOP/s). Their work split comes from the shape and the
card's SM count: ``f32_fwd_plan`` (item groups a block, blocks) and
``f32_dw_plan`` (slices of an item, items a block, blocks).
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


# -- the f32 route (csrc/conv_f32.cu) ------------------------------------------

# Launches of its CUDA kernels
f32_launches = 0     # forwards and input gradients
f32_dw_launches = 0  # weight gradients (each a kernel and its fixed-order reduce)

F32_TAPS = 15         # odd k <= 15, centred in 15 taps
F32_STRIP = 288       # bins per work item: 32 lanes x 9
F32_XS = 303          # a staged input row's stride (floats)
F32_DSTRIP = 144      # weight gradient: bins per work item
F32_DXS = 159         # its staged input row's stride
F32_CD = 5            # weight gradient: output channels per thread
F32_CDP = 6           # their slots in the staged dy
F32_MAX_GROUPS = 15
F32_FWD_THREADS = {10: 256, 1: 1024}  # a block's threads by channels per warp
F32_DW_THREADS = 320
SMEM_MAX = 232448     # a block's shared memory on the H100 (bytes)
SM_SMEM = 233472      # an SM's


def f32_route(kernel_size: int, in_channels: int, out_channels: int, stride: int = 1,
              padding=None, dilation: int = 1, groups: int = 1,
              padding_mode: str = "zeros") -> bool:
    """Whether the f32 kernels take a Conv1d layer: a 'same' (zero-padded,
    stride 1, undilated, ungrouped) convolution with odd 1 < k <= 15 and
    1 <= C_in, C_out <= MAX_CH. ``padding`` None stands for (k - 1) / 2."""
    k = kernel_size
    if padding is None:
        padding = (k - 1) // 2
    return (1 < k <= F32_TAPS and k % 2 == 1 and 1 <= in_channels <= MAX_CH
            and 1 <= out_channels <= MAX_CH and stride == 1 and dilation == 1 and groups == 1
            and padding == (k - 1) // 2 and padding_mode == "zeros")


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def f32_strips(width: int) -> int:
    return -(-width // F32_STRIP)


def f32_channels_per_warp(cout: int) -> int:
    """Output channels per warp of the forward: 10, or 1 for C_out <= 4."""
    return 10 if cout > 4 else 1


def f32_fwd_smem(cin: int, cout: int, groups: int) -> int:
    """Bytes of the forward's shared memory: the weight [cin][15][C_out
    padded], then per group the input strip or the output strip."""
    ct = f32_channels_per_warp(cout)
    cp = -(-cout // ct) * ct
    return 4 * (_round4(cin * F32_TAPS * cp)
                + groups * _round4(max(cin * F32_XS, cp * F32_STRIP)))


def f32_fwd_plan(rows: int, width: int, cin: int, cout: int, n_sm: int) -> Tuple[int, int]:
    """(item groups a block, blocks) of the forward: as many groups as the
    shared memory and the thread limit admit (at most one per item), one
    persistent block per SM, never more than the groups the items fill."""
    ct = f32_channels_per_warp(cout)
    group_threads = 32 * -(-cout // ct)
    items = rows * f32_strips(width)
    groups = 1
    while (groups < min(F32_MAX_GROUPS, items)
           and (groups + 1) * group_threads <= F32_FWD_THREADS[ct]
           and f32_fwd_smem(cin, cout, groups + 1) <= SMEM_MAX):
        groups += 1
    return groups, min(n_sm, -(-items // groups))


def f32_dw_strips(width: int) -> int:
    return -(-width // F32_DSTRIP)


def f32_dw_smem(cin: int, cout: int, slices: int) -> int:
    """Bytes of the weight gradient's shared memory: two stages of the
    input strip and dy, then the block's running sums, 75 a thread."""
    n_cg = -(-cout // F32_CD)
    stage = _round4(cin * F32_DXS) + F32_DSTRIP * _round4(n_cg * F32_CDP)
    return 4 * (2 * stage + F32_CD * F32_TAPS * slices * cin * n_cg)


def f32_dw_slices(cin: int, cout: int) -> int:
    """Slices of an item in the weight gradient: a thread per (slice, input
    channel, 5 output channels), the slices doubled (up to 16, 9 bins each)
    while the block stays within 320 threads."""
    per_slice = cin * -(-cout // F32_CD)
    slices = 1
    while slices < F32_DSTRIP // 9 and 2 * slices * per_slice <= F32_DW_THREADS:
        slices *= 2
    return slices


def f32_dw_blocks_per_sm(cin: int, cout: int) -> int:
    """Blocks of the weight gradient an SM holds: two where two fit its
    shared memory (228 KB, 1 KB of it reserved a block) and 320 threads,
    else one."""
    slices = f32_dw_slices(cin, cout)
    threads = slices * cin * -(-cout // F32_CD)
    fits = 2 * (f32_dw_smem(cin, cout, slices) + 1024) <= SM_SMEM
    return 2 if fits and 2 * threads <= F32_DW_THREADS else 1


def f32_dw_plan(rows: int, width: int, cin: int, cout: int,
                n_sm: int) -> Tuple[int, int, int]:
    """(slices of an item, items a block, blocks) of the weight gradient:
    the (row, 144-bin strip) items cut into one run per block, as many
    blocks as the SMs hold at once, each run summed by one block."""
    items = rows * f32_dw_strips(width)
    per = -(-items // (f32_dw_blocks_per_sm(cin, cout) * n_sm))
    return f32_dw_slices(cin, cout), per, -(-items // per)


def f32_dw_scratch(cin: int, cout: int, blocks: int) -> int:
    """Floats of the weight gradient's scratch: each block's sums, 75 a
    (input channel, 5 output channels)."""
    return blocks * F32_CD * F32_TAPS * cin * -(-cout // F32_CD)


def _bind_f32() -> ctypes.CDLL:
    lib = _build.load("conv_f32")
    fwd = lib.conv1d_f32_fwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    dw = lib.conv1d_f32_dw
    dw.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    dw.restype = ctypes.c_int
    return lib


def conv1d_f32_forward(x: torch.Tensor, weight: torch.Tensor, bias=None,
                       transposed: bool = False) -> torch.Tensor:
    """x [B, C_in, W] -> [B, C_out, W] in f32 (no autograd): the 'same'
    conv with ``weight`` [C_out, C_in, k] and ``bias`` [C_out] or None; with
    ``transposed``, ``weight`` is [C_in, C_out, k] and is read tap-flipped
    (the input gradient of the conv it belongs to)."""
    if x.device.type == "cpu":
        w = weight.flip(-1).transpose(0, 1) if transposed else weight
        return F.conv1d(x, w, bias, padding=(w.shape[-1] - 1) // 2)
    _check("conv1d_f32_forward", x, weight, torch.float32)
    rows, cin, width = x.shape
    cout, wcin, k = weight.shape
    if transposed:
        cout, wcin = wcin, cout
    if wcin != cin:
        raise ValueError(f"conv1d_f32_forward: x {tuple(x.shape)}, weight {tuple(weight.shape)} "
                         f"(transposed {transposed})")
    _check_shape("conv1d_f32_forward", rows, cin, cout, width, k)
    if bias is not None and (bias.shape != (cout,) or bias.dtype != torch.float32
                             or bias.device != x.device):
        raise ValueError(f"conv1d_f32_forward: bias {tuple(bias.shape)} {bias.dtype} for "
                         f"C_out {cout}")
    x, weight = x.contiguous(), weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    y = torch.empty((rows, cout, width), dtype=torch.float32, device=x.device)
    groups, blocks = f32_fwd_plan(rows, width, cin, cout, _sm_count(x.device.index or 0))
    err = _bind_f32().conv1d_f32_fwd(x.data_ptr(), weight.data_ptr(),
                                     None if bias is None else bias.data_ptr(), y.data_ptr(),
                                     rows, cin, cout, width, k, int(transposed), groups, blocks,
                                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv1d_f32_fwd")
    global f32_launches
    f32_launches += 1
    return y


def conv1d_f32_weight(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dW [C_out, C_in, k] of the 'same' conv in f32 from x [B, C_in, W]
    and dy [B, C_out, W] (no autograd)."""
    if x.device.type == "cpu":
        return torch.nn.grad.conv1d_weight(x, (dy.shape[1], x.shape[1], k), dy,
                                           padding=(k - 1) // 2)
    _check("conv1d_f32_weight", x, dy, torch.float32)
    rows, cin, width = x.shape
    cout = dy.shape[1]
    if dy.shape != (rows, cout, width):
        raise ValueError(f"conv1d_f32_weight: x {tuple(x.shape)}, dy {tuple(dy.shape)}, k {k}")
    _check_shape("conv1d_f32_weight", rows, cin, cout, width, k)
    x, dy = x.contiguous(), dy.contiguous()
    slices, per, blocks = f32_dw_plan(rows, width, cin, cout, _sm_count(x.device.index or 0))
    partial = torch.empty(f32_dw_scratch(cin, cout, blocks), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((cout, cin, k), dtype=torch.float32, device=x.device)
    err = _bind_f32().conv1d_f32_dw(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                                    dw.data_ptr(), rows, cin, cout, width, k, slices, per,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv1d_f32_dw")
    global f32_dw_launches
    f32_dw_launches += 1
    return dw


class _Conv1dF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return conv1d_f32_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv1d_f32_forward(dy, weight, None, transposed=True)
        if ctx.needs_input_grad[1]:
            dw = conv1d_f32_weight(x, dy, weight.shape[-1])
        if ctx.needs_input_grad[2]:
            db = dy.sum((0, 2))
        return dx, dw, db


def conv1d_f32(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """Differentiable 'same' conv1d in f32: x [B, C_in, W], weight [C_out,
    C_in, k] (odd k), bias [C_out] or None -> [B, C_out, W]."""
    return _Conv1dF32.apply(x, weight, bias)
