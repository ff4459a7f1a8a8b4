"""Sinusoidal synth: hand-written CUDA forward and backward kernels and the
plain version.

Replaces the TPU kernels ``sot_tpu/ops/pallas/synth.py:_fwd_kernel`` and
``:_bwd_kernel`` (entry ``synth_render``, VJP of ``synth_lanes``). The CUDA
source is ``sot_tpu_torch/csrc/synth.cu``.

Frame-rate controls [B, F, K] (amplitudes already Nyquist-masked at frame
rate, harmonic frequencies in Hz) -> audio [B, T]: bilinear f-envelope,
hann-OLA a-envelope, per-sample Nyquist mask, unwrapped phase prefix,
``env_a * sin(phase)`` summed over the K sinusoids in k order.

Bound on the H100: operations (5.24 M lane-samples of f-envelope
arithmetic and float64 prefix at the serving shape [64, 16, 20] ->
[64, 4096], and a full-range sinf where the sample is below Nyquist; ~0.2
MB in, 1 MB out). Two launches, each one block per (clip, 512-sample
segment) of 8 warps, two per 128-sample chunk taking the even and the odd
harmonics, four consecutive samples per lane: the float64 phase total of
every chunk, then the harmonics' terms in shared memory, summed in k order
per sample; envelopes bit-equal to ``ops/resample.py`` and the phase
bit-equal to the plain version's float64 cumsum (the sum is exact for the
model's controls); see the source for the design notes.

The backward (an ``autograd.Function`` around the kernels) gives d
amplitudes and d frequencies [B, F, K] from the audio cotangent: the
function autograd computes through ``synth_render_plain``, with the phase
as there, its float64 suffix sum in a fixed order and frame sums in a fixed
order (fp-close, not bit-equal; ROADMAP keeps its training verdict open).
One block per (clip, harmonic); bound: operations, as the forward.

On a CPU tensor ``synth_render`` runs ``synth_render_plain`` (autograd
differentiates it); on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from sot_tpu_torch.ops.kernels import _build
from sot_tpu_torch.ops.oscillator import oscillator_bank, remove_above_nyquist
from sot_tpu_torch.ops.resample import linear_taps, resample
from sot_tpu_torch.ops.scan import prefix_sum
from sot_tpu_torch.ops.windows import hann_window

# Launches of the CUDA kernels (plain-version calls are not counted).
launches = 0           # forward
backward_launches = 0  # backward

_SAMPLE_MULTIPLE = 256  # n_samples must be a multiple (csrc/synth.cu tiles 128-sample chunks)
_CHUNK = 128            # samples of one warp of csrc/synth.cu
_MAX_SAMPLES = 8192
_MAX_FRAMES = 128


def synth_envelopes_plain(amplitudes: torch.Tensor, frequencies: torch.Tensor,
                          n_samples: int, sample_rate: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample-rate (env_f, Nyquist-masked env_a), each [B, T, K]."""
    env_a = resample(amplitudes, n_samples, method="window", add_endpoint=True)
    env_f = resample(frequencies, n_samples)
    return env_f, remove_above_nyquist(env_f, env_a, sample_rate)


def synth_phase_plain(env_f: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """The unwrapped phase [B, T, K] of ``oscillator_bank`` for the
    sample-rate frequency envelope: f32 increments, a float64 prefix sum,
    each phase rounded once."""
    return prefix_sum(env_f * (2.0 * math.pi / float(sample_rate)), axis=1)


def synth_render_plain(amplitudes: torch.Tensor, frequencies: torch.Tensor,
                       n_samples: int, sample_rate: int) -> torch.Tensor:
    """resample + oscillator_bank: [B, F, K] controls -> [B, T] audio."""
    env_f, env_a = synth_envelopes_plain(amplitudes, frequencies, n_samples, sample_rate)
    return oscillator_bank(env_f, env_a, sample_rate)


@functools.lru_cache(maxsize=8)
def _tables(n_frames: int, n_samples: int, device: torch.device):
    """Per-sample bilinear taps (lo, frac), the OLA hann window, and the
    sample ranges [start[f], start[f+1]) with lo == f and with hi == f."""
    lo, hi, frac = linear_taps(n_frames, n_samples, align_corners=False)
    hop = n_samples // n_frames
    frames = np.arange(n_frames + 1)
    lo_start = np.searchsorted(lo, frames, side="left").astype(np.int32)
    hi_start = np.searchsorted(hi, frames, side="left").astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (
        lo.astype(np.int32), frac, hann_window(2 * hop), lo_start, hi_start))


def _bind() -> ctypes.CDLL:
    lib = _build.load("synth")
    fn = lib.synth_forward_f32
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.synth_backward_f32
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _scalars(sample_rate: int) -> Tuple[float, float]:
    """(nyquist, omega_scale) as the float32 values the plain version uses."""
    return (float(np.float32(sample_rate / 2.0)),
            float(np.float32(2.0 * math.pi / float(sample_rate))))


class _SynthRender(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its VJP."""

    @staticmethod
    def forward(ctx, amplitudes, frequencies, n_samples, sample_rate):
        ctx.save_for_backward(amplitudes, frequencies)
        ctx.shape = (n_samples, sample_rate)
        return _launch_forward(amplitudes, frequencies, n_samples, sample_rate, False)

    @staticmethod
    def backward(ctx, dout):
        amplitudes, frequencies = ctx.saved_tensors
        n_samples, sample_rate = ctx.shape
        d_amps, d_freqs = synth_backward(amplitudes, frequencies, dout.contiguous(),
                                         n_samples, sample_rate)
        return d_amps, d_freqs, None, None


def synth_render(amplitudes: torch.Tensor, frequencies: torch.Tensor, n_samples: int,
                 sample_rate: int, debug_envelopes: bool = False):
    """[B, F, K] controls -> [B, n_samples] audio, differentiable in both.

    With ``debug_envelopes`` (CUDA only, no autograd) returns ``(audio,
    env_f, env_a, phase)``: the kernel's envelopes and rounded phase, each
    [B, T, K], for bit-equality checks against ``synth_envelopes_plain`` and
    ``synth_phase_plain`` (a separate instantiation of the kernel that
    writes them; the normal path writes no debug tensors).
    """
    if amplitudes.device.type == "cpu":
        if debug_envelopes:
            raise ValueError("synth_render: debug_envelopes is for the CUDA kernel")
        return synth_render_plain(amplitudes, frequencies, n_samples, sample_rate)
    _check(amplitudes, frequencies, n_samples)
    if debug_envelopes:
        return _launch_forward(amplitudes, frequencies, n_samples, sample_rate, True)
    return _SynthRender.apply(amplitudes, frequencies, n_samples, sample_rate)


def _check(amplitudes: torch.Tensor, frequencies: torch.Tensor, n_samples: int) -> None:
    dev = amplitudes.device
    if dev.type != "cuda" or frequencies.device != dev:
        raise ValueError(f"synth_render: tensors on {dev} / {frequencies.device}")
    if amplitudes.dtype != torch.float32 or frequencies.dtype != torch.float32:
        raise TypeError("synth_render: the CUDA kernel takes float32 controls")
    if amplitudes.ndim != 3 or amplitudes.shape != frequencies.shape:
        raise ValueError(f"synth_render: expected matching [B, F, K] controls, got "
                         f"{tuple(amplitudes.shape)} / {tuple(frequencies.shape)}")
    if not (amplitudes.is_contiguous() and frequencies.is_contiguous()):
        raise ValueError("synth_render: controls must be contiguous")
    batch, n_frames, n_sin = amplitudes.shape
    if (n_samples <= 0 or n_samples % _SAMPLE_MULTIPLE or n_samples > _MAX_SAMPLES
            or n_frames > _MAX_FRAMES or n_frames < 2 or n_samples % n_frames
            or batch < 1 or n_sin < 1):
        raise ValueError(
            f"synth_render: kernel covers n_samples % {_SAMPLE_MULTIPLE} == 0, 0 < n_samples "
            f"<= {_MAX_SAMPLES}, 2 <= n_frames <= {_MAX_FRAMES}, n_frames | n_samples, "
            f"batch >= 1 and K >= 1; got n_samples={n_samples}, controls "
            f"{tuple(amplitudes.shape)}")


def _launch_forward(amplitudes, frequencies, n_samples, sample_rate, debug_envelopes):
    dev = amplitudes.device
    batch, n_frames, n_sin = amplitudes.shape
    lo, frac, window, _, _ = _tables(n_frames, n_samples, dev)
    lib = _bind()
    totals = torch.empty((batch, n_sin, n_samples // _CHUNK), dtype=torch.float64, device=dev)
    audio = torch.empty((batch, n_samples), dtype=torch.float32, device=dev)
    dbg = [None, None, None]
    if debug_envelopes:
        dbg = [torch.empty((batch, n_sin, n_samples), dtype=torch.float32, device=dev)
               for _ in range(3)]
    nyquist, omega_scale = _scalars(sample_rate)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.synth_forward_f32(
        amplitudes.data_ptr(), frequencies.data_ptr(), lo.data_ptr(), frac.data_ptr(),
        window.data_ptr(), totals.data_ptr(), audio.data_ptr(),
        *(d.data_ptr() if d is not None else None for d in dbg),
        batch, n_frames, n_sin, n_samples, nyquist, omega_scale, stream)
    _build.check(err, "synth_forward_f32")
    global launches
    launches += 1
    if debug_envelopes:
        return (audio,) + tuple(d.transpose(1, 2) for d in dbg)
    return audio


def synth_backward(amplitudes: torch.Tensor, frequencies: torch.Tensor,
                   dout: torch.Tensor, n_samples: int, sample_rate: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: (d amplitudes, d frequencies), [B, F, K]
    each, for the audio cotangent ``dout`` [B, n_samples] (CUDA only)."""
    _check(amplitudes, frequencies, n_samples)
    batch, n_frames, n_sin = amplitudes.shape
    if (dout.device != amplitudes.device or dout.dtype != torch.float32
            or tuple(dout.shape) != (batch, n_samples) or not dout.is_contiguous()):
        raise ValueError(f"synth_backward: dout must be a contiguous float32 "
                         f"[{batch}, {n_samples}] tensor on {amplitudes.device}")
    dev = amplitudes.device
    lo, frac, window, lo_start, hi_start = _tables(n_frames, n_samples, dev)
    lib = _bind()
    d_amps = torch.empty_like(amplitudes)
    d_freqs = torch.empty_like(frequencies)
    nyquist, omega_scale = _scalars(sample_rate)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.synth_backward_f32(
        amplitudes.data_ptr(), frequencies.data_ptr(), lo.data_ptr(), frac.data_ptr(),
        window.data_ptr(), lo_start.data_ptr(), hi_start.data_ptr(), dout.data_ptr(),
        d_amps.data_ptr(), d_freqs.data_ptr(), batch, n_frames, n_sin, n_samples,
        nyquist, omega_scale, stream)
    _build.check(err, "synth_backward_f32")
    global backward_launches
    backward_launches += 1
    return d_amps, d_freqs
