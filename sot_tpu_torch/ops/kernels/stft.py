"""STFT frontend (pad_end framing + window + real-DFT projection): hand-written
CUDA kernel and its plain version.

Replaces the TPU kernel ``sot_tpu/ops/pallas/stft.py:_frontend_kernel``
(entry ``_project_pallas``, caller ``stft_frontend_projection``; kernel
B9). The CUDA source is ``sot_tpu_torch/csrc/stft.cu``.

    proj[b, c, :] = frame_c(audio[b]) @ Mw,   Mw = window[:, None] * [cos | -sin]

for the C = T / hop pad_end frames of each clip: [batch, C, 2(n_fft/2+1)],
re and im concatenated. The window is folded into the basis in f32
(``_windowed_dft``), as the JAX package folds it.

  * ``stft_frontend_projection_plain`` — ``frame_signal(audio) @ Mw``
  * ``stft_frontend_projection`` — the differentiable entry: the plain
    version on a CPU tensor, the kernel on a CUDA tensor (or raise); the
    backward is JAX's ``_frontend_bwd`` (``stft.py:169-176``): dproj @ Mw^T,
    then the overlap-add, a plain matmul and sums as JAX leaves them to XLA
  * ``frontend_applicable`` — JAX's conditions (``stft.py:182-194``)

Bound on the H100: bytes (the function is an O(n log n) rfft of each
windowed frame, ~9.4 MB moved at the 2048/256 loss STFT of 64 clips). The
kernel is a tiled SIMT SGEMM reading the frames straight from the audio, so
it does the dense DFT product (8.6 GFLOP at that shape, 32.3 GFLOP over the
gated train step's four shapes), see the source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sot_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel (plain-version calls are not counted).
launches = 0

_BN = 128   # block tile width of csrc/framed_gemm.cuh: the basis row stride
_BK = 8     # block tile depth
_MAX_SPLITS = 8
_SMS = 132  # streaming multiprocessors of an H100 SXM


def frontend_applicable(n_fft: int, hop: int, t: int, pad_end: bool, center: bool) -> bool:
    """The JAX package's conditions for the fused frontend: pad_end framing
    without centring, hop a multiple of 128 (a TPU lane artefact, kept so
    that the gated step sends the same scales to the same function) and hop
    dividing both T and n_fft."""
    return bool(pad_end and not center and hop % 128 == 0 and t % hop == 0
                and n_fft % hop == 0)


def _windowed_dft(n_fft: int, window: np.ndarray) -> np.ndarray:
    """[n_fft, ldb] real-DFT basis [cos | -sin] with the window folded in,
    in f32, columns padded with zeros to a multiple of 128
    (``sot_tpu/ops/pallas/stft.py:_windowed_dft``)."""
    win = np.asarray(window, np.float32)
    k = np.arange(n_fft // 2 + 1)
    t = np.arange(n_fft)
    ang = 2.0 * np.pi * t[:, None] * k[None, :] / n_fft
    m = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    m *= win[:, None]
    n_cols = m.shape[1]
    ldb = -(-n_cols // _BN) * _BN
    return np.pad(m, ((0, 0), (0, ldb - n_cols)))


_BASES: dict = {}


def windowed_dft(n_fft: int, window: np.ndarray, device: torch.device) -> torch.Tensor:
    """``_windowed_dft`` as a tensor on ``device`` (cached per window and device)."""
    key = (n_fft, np.ascontiguousarray(window, np.float32).tobytes(), str(device))
    basis = _BASES.get(key)
    if basis is None:
        basis = _BASES[key] = torch.from_numpy(_windowed_dft(n_fft, window)).to(device)
    return basis


def _frames(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[batch, T] -> the C = T / hop pad_end frames [batch, C, n_fft]."""
    t = audio.shape[-1]
    padded = torch.nn.functional.pad(audio, (0, n_fft - hop))
    return padded.unfold(-1, n_fft, hop)[:, :t // hop]


def stft_frontend_projection_plain(audio: torch.Tensor, n_fft: int, hop: int,
                                   basis: torch.Tensor) -> torch.Tensor:
    """The frames times the windowed basis, one f32 matmul:
    [batch, T] -> [batch, C, 2(n_fft/2+1)]."""
    n_cols = 2 * (n_fft // 2 + 1)
    return torch.matmul(_frames(audio, n_fft, hop), basis[:, :n_cols])


def _splits(tiles: int, n_fft: int) -> int:
    """Splits over K so that the output tiles fill the SMs, each split a
    whole number of K tiles."""
    s = 1
    while s < _MAX_SPLITS and tiles * s < _SMS and n_fft % (2 * s * _BK) == 0:
        s *= 2
    return s


def _bind() -> ctypes.CDLL:
    lib = _build.load("stft")
    fn = lib.stft_frontend_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def stft_frontend_kernel(audio: torch.Tensor, n_fft: int, hop: int,
                         basis: torch.Tensor) -> torch.Tensor:
    """The projection [batch, C, 2(n_fft/2+1)] of ``audio`` [batch, T] (no
    autograd): the plain version on a CPU tensor, else the kernel."""
    if audio.device.type == "cpu":
        return stft_frontend_projection_plain(audio, n_fft, hop, basis)
    if audio.device.type != "cuda" or basis.device != audio.device:
        raise ValueError(f"stft_frontend: tensors on {audio.device} / {basis.device}")
    if audio.dtype != torch.float32 or basis.dtype != torch.float32:
        raise TypeError("stft_frontend: the CUDA kernel takes float32 audio and basis")
    if audio.ndim != 2 or basis.ndim != 2:
        raise ValueError("stft_frontend: expected audio [batch, T] and basis [n_fft, N]")
    batch, t = audio.shape
    n_cols = 2 * (n_fft // 2 + 1)
    ldb = basis.shape[1]
    if (basis.shape[0] != n_fft or ldb % _BN or n_cols > ldb or n_fft % _BK
            or not frontend_applicable(n_fft, hop, t, True, False)):
        raise ValueError(f"stft_frontend: n_fft {n_fft}, hop {hop}, T {t}, basis "
                         f"{tuple(basis.shape)}: needs hop % 128 == 0, hop | T, hop | n_fft "
                         f"and a basis [n_fft, multiple of {_BN}]")
    audio, basis = audio.contiguous(), basis.contiguous()
    if basis.data_ptr() % 16:
        raise ValueError("stft_frontend: the basis must be 16-byte aligned")
    n_frames = t // hop
    m_rows = batch * n_frames
    splits = _splits((ldb // _BN) * (-(-m_rows // 128)), n_fft)
    partial = torch.empty((splits, m_rows, ldb), dtype=torch.float32, device=audio.device)
    out = torch.empty((batch, n_frames, n_cols), dtype=torch.float32, device=audio.device)
    err = _bind().stft_frontend_f32(audio.data_ptr(), basis.data_ptr(), partial.data_ptr(),
                                    out.data_ptr(), batch, t, n_frames, hop, n_fft, ldb,
                                    n_cols, splits,
                                    torch.cuda.current_stream(audio.device).cuda_stream)
    _build.check(err, "stft_frontend_f32")
    global launches
    launches += 1
    return out


def overlap_add(dframes: torch.Tensor, hop: int, t: int) -> torch.Tensor:
    """Frame cotangents [batch, C, n_fft] summed back onto the audio [batch,
    T]: chunk r of frame c lands on samples [(c+r) hop, (c+r+1) hop), added
    for r = 0, 1, ... in order (``stft.py:_ola``)."""
    batch, n_frames, n_fft = dframes.shape
    q = n_fft // hop
    chunks = dframes.reshape(batch, n_frames, q, hop)
    total = dframes.new_zeros((batch, n_frames + q - 1, hop))
    for r in range(q):
        total[:, r:r + n_frames] += chunks[:, :, r]
    return total.reshape(batch, -1)[:, :t]


class _Frontend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, audio, n_fft, hop, basis):
        ctx.save_for_backward(basis)
        ctx.n_fft, ctx.hop, ctx.t = n_fft, hop, audio.shape[-1]
        return stft_frontend_kernel(audio, n_fft, hop, basis)

    @staticmethod
    def backward(ctx, dproj):
        (basis,) = ctx.saved_tensors
        n_cols = 2 * (ctx.n_fft // 2 + 1)
        dframes = torch.matmul(dproj, basis[:, :n_cols].T)
        return overlap_add(dframes, ctx.hop, ctx.t), None, None, None


def stft_frontend_projection(audio: torch.Tensor, n_fft: int, hop: int,
                             window: np.ndarray) -> torch.Tensor:
    """rfft projection [batch, C, 2(n_fft/2+1)] of the ``window``-weighted
    pad_end frames of ``audio`` [batch, T], re | im along the last axis;
    differentiable in ``audio``. Requires ``frontend_applicable``."""
    basis = windowed_dft(n_fft, window, audio.device)
    return _Frontend.apply(audio, n_fft, hop, basis)
