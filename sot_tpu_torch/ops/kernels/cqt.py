"""CQT projection: hand-written CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``sot_tpu/ops/pallas/cqt.py:_cqt_slab_kernel``
(entry ``cqt_project``). The CUDA source is ``sot_tpu_torch/csrc/cqt.cu``.

    proj[b, f, n] = sum_w xpad[b, f*hop + w] * bank[w, n]

Bound on the H100: operations (over the bank's non-zero support, 14.1% of
its entries: 2*1024*nnz = 5.4 GFLOP per 64-clip request against ~22 MB).
The kernel computes the dense product (2*1024*32768*570 = 38.2 GFLOP
against ~86 MB of operands) as a tiled SIMT SGEMM that
reads the overlapping windows straight from the padded signal (no frame
matrix in device memory), in f32 with f32 accumulation, split over K with a
fixed-order reduction; see the source for the design notes.

On a CPU tensor ``cqt_project`` runs ``cqt_project_plain``; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from sot_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel (plain-version calls are not counted).
launches = 0

_BN = 128   # block tile width of csrc/cqt.cu: the bank's row stride must be a multiple
_BK = 8     # block tile depth
_MAX_SPLITS = 16


def cqt_project_plain(xpad: torch.Tensor, bank: torch.Tensor, hop: int,
                      n_frames: int, n_out: int) -> torch.Tensor:
    """Unfold the windows and one f32 matmul: [B, T_pad] x [W, >= n_out]
    -> [B, n_frames, n_out]."""
    width = bank.shape[0]
    frames = xpad.unfold(1, width, hop)[:, :n_frames]
    return torch.matmul(frames, bank[:, :n_out])


def _splits(width: int) -> int:
    s = _MAX_SPLITS
    while s > 1 and width % (s * _BK):
        s //= 2
    return s


def _bind() -> ctypes.CDLL:
    lib = _build.load("cqt")
    fn = lib.cqt_project_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def cqt_project(xpad: torch.Tensor, bank: torch.Tensor, hop: int, n_frames: int,
                n_out: int) -> torch.Tensor:
    """[B, T_pad] padded audio x [W, ldb] bank -> [B, n_frames, n_out] f32.

    ``bank`` columns n_out..ldb-1 must be zero; on CUDA ``ldb`` must be a
    multiple of 128 (``ops.cqt`` pads the bank once when it caches it).
    """
    if xpad.device.type == "cpu":
        return cqt_project_plain(xpad, bank, hop, n_frames, n_out)
    if xpad.device.type != "cuda" or bank.device != xpad.device:
        raise ValueError(f"cqt_project: tensors on {xpad.device} / {bank.device}")
    if xpad.dtype != torch.float32 or bank.dtype != torch.float32:
        raise TypeError("cqt_project: the CUDA kernel takes float32 audio and bank")
    if xpad.ndim != 2 or bank.ndim != 2:
        raise ValueError("cqt_project: expected xpad [B, T] and bank [W, N]")
    if not (xpad.is_contiguous() and bank.is_contiguous()):
        raise ValueError("cqt_project: inputs must be contiguous")
    batch, t_pad = xpad.shape
    width, ldb = bank.shape
    if ldb % _BN or n_out > ldb or width % _BK:
        raise ValueError(f"cqt_project: bank {tuple(bank.shape)} needs a row stride "
                         f"that is a multiple of {_BN} and a width multiple of {_BK}")
    if n_frames < 1 or (n_frames - 1) * hop + width > t_pad:
        raise ValueError(f"cqt_project: {n_frames} frames at hop {hop} of width "
                         f"{width} overrun the padded signal of {t_pad}")
    if bank.data_ptr() % 16:
        raise ValueError("cqt_project: the bank must be 16-byte aligned")
    splits = _splits(width)
    lib = _bind()
    partial = torch.empty((splits, batch * n_frames, ldb), dtype=torch.float32,
                          device=xpad.device)
    out = torch.empty((batch, n_frames, n_out), dtype=torch.float32, device=xpad.device)
    stream = torch.cuda.current_stream(xpad.device).cuda_stream
    err = lib.cqt_project_f32(xpad.data_ptr(), bank.data_ptr(), partial.data_ptr(),
                              out.data_ptr(), batch, t_pad, n_frames, hop, width, ldb,
                              n_out, splits, stream)
    _build.check(err, "cqt_project_f32")
    global launches
    launches += 1
    return out
