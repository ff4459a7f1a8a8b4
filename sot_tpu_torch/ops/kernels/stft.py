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
kernel computes that rfft: each frame is read straight from the audio,
windowed, packed two samples to a complex point and transformed by an
in-shared-memory Stockham FFT of n/2 points with a real post-twiddle; one
launch per STFT, no scratch. Twiddles come from ``twiddles`` (float64 on
the host, rounded once to f32). See the source for the design notes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sot_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel (plain-version calls are not counted).
launches = 0

_BN = 128   # the windowed basis' columns are padded to a multiple of this
# the transform sizes the kernel takes (csrc/stft.cu instantiates these)
FFT_SIZES = (256, 512, 1024, 2048)


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


def _twiddles(n_fft: int) -> np.ndarray:
    """[n_fft, 2] f32 table (cos, -sin) of exp(-2 pi i m / n_fft), m < n_fft:
    computed in float64 and rounded once."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


_TWIDDLES: dict = {}
_WINDOWS: dict = {}


def twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """``_twiddles`` as a tensor on ``device`` (cached per size and device)."""
    key = (n_fft, str(device))
    table = _TWIDDLES.get(key)
    if table is None:
        table = _TWIDDLES[key] = torch.from_numpy(_twiddles(n_fft)).to(device)
    return table


def window_tensor(window: np.ndarray, device: torch.device) -> torch.Tensor:
    """The f32 window as a tensor on ``device`` (cached per window and device)."""
    win = np.ascontiguousarray(window, np.float32)
    key = (win.tobytes(), str(device))
    t = _WINDOWS.get(key)
    if t is None:
        t = _WINDOWS[key] = torch.from_numpy(win).to(device)
    return t


def _bind() -> ctypes.CDLL:
    lib = _build.load("stft")
    fn = lib.stft_frontend_fft
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def stft_frontend_kernel(audio: torch.Tensor, n_fft: int, hop: int,
                         window: torch.Tensor) -> torch.Tensor:
    """The projection [batch, C, 2(n_fft/2+1)] of ``audio`` [batch, T] with
    the f32 ``window`` [n_fft] (no autograd): the plain version on a CPU
    tensor, else the kernel."""
    if audio.device.type == "cpu":
        basis = windowed_dft(n_fft, window.numpy(), audio.device)
        return stft_frontend_projection_plain(audio, n_fft, hop, basis)
    if audio.device.type != "cuda" or window.device != audio.device:
        raise ValueError(f"stft_frontend: tensors on {audio.device} / {window.device}")
    if audio.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError("stft_frontend: the CUDA kernel takes float32 audio and window")
    if audio.ndim != 2 or window.shape != (n_fft,):
        raise ValueError("stft_frontend: expected audio [batch, T] and window [n_fft]")
    if n_fft not in FFT_SIZES:
        raise ValueError(f"stft_frontend: n_fft {n_fft}: the CUDA kernel takes an FFT size "
                         f"in {FFT_SIZES}")
    batch, t = audio.shape
    if not frontend_applicable(n_fft, hop, t, True, False):
        raise ValueError(f"stft_frontend: n_fft {n_fft}, hop {hop}, T {t}: needs hop % 128 "
                         f"== 0, hop | T and hop | n_fft")
    audio, window = audio.contiguous(), window.contiguous()
    n_frames = t // hop
    out = torch.empty((batch, n_frames, n_fft + 2), dtype=torch.float32, device=audio.device)
    err = _bind().stft_frontend_fft(audio.data_ptr(), window.data_ptr(),
                                    twiddles(n_fft, audio.device).data_ptr(), out.data_ptr(),
                                    batch, t, n_frames, hop, n_fft,
                                    torch.cuda.current_stream(audio.device).cuda_stream)
    _build.check(err, "stft_frontend_fft")
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
    def forward(ctx, audio, n_fft, hop, window):
        ctx.n_fft, ctx.hop, ctx.t, ctx.window = n_fft, hop, audio.shape[-1], window
        return stft_frontend_kernel(audio, n_fft, hop, window_tensor(window, audio.device))

    @staticmethod
    def backward(ctx, dproj):
        basis = windowed_dft(ctx.n_fft, ctx.window, dproj.device)
        n_cols = 2 * (ctx.n_fft // 2 + 1)
        dframes = torch.matmul(dproj, basis[:, :n_cols].T)
        return overlap_add(dframes, ctx.hop, ctx.t), None, None, None


def stft_frontend_projection(audio: torch.Tensor, n_fft: int, hop: int,
                             window: np.ndarray) -> torch.Tensor:
    """rfft projection [batch, C, 2(n_fft/2+1)] of the ``window``-weighted
    pad_end frames of ``audio`` [batch, T], re | im along the last axis;
    differentiable in ``audio``. Requires ``frontend_applicable``."""
    return _Frontend.apply(audio, n_fft, hop, window)
