"""Sinusoidal synth forward: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``sot_tpu/ops/pallas/synth.py:_fwd_kernel`` (entry
``synth_render``). The CUDA source is ``sot_tpu_torch/csrc/synth.cu``.

Frame-rate controls [B, F, K] (amplitudes already Nyquist-masked at frame
rate, harmonic frequencies in Hz) -> audio [B, T]: bilinear f-envelope,
hann-OLA a-envelope, per-sample Nyquist mask, unwrapped phase prefix,
``env_a * sin(phase)`` summed over the K sinusoids.

Bound on the H100: operations (5.24 M lane-samples of envelope arithmetic,
prefix sum and a full-range sinf at the serving shape [64, 16, 20] ->
[64, 4096]; ~0.2 MB in, 1 MB out). One block per (clip, harmonic) lane with a
block-wide scan; envelopes bit-equal to ``ops/resample.py``; a fixed-order
harmonic sum; see the source for the design notes.

On a CPU tensor ``synth_render`` runs ``synth_render_plain``; on a CUDA tensor
it launches the kernel or raises.
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
from sot_tpu_torch.ops.windows import hann_window

# Launches of the CUDA kernel (plain-version calls are not counted).
launches = 0

_THREADS = 256      # csrc/synth.cu block size: n_samples must be a multiple
_MAX_SAMPLES = 8192
_MAX_FRAMES = 128


def synth_envelopes_plain(amplitudes: torch.Tensor, frequencies: torch.Tensor,
                          n_samples: int, sample_rate: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample-rate (env_f, Nyquist-masked env_a), each [B, T, K]."""
    env_a = resample(amplitudes, n_samples, method="window", add_endpoint=True)
    env_f = resample(frequencies, n_samples)
    return env_f, remove_above_nyquist(env_f, env_a, sample_rate)


def synth_render_plain(amplitudes: torch.Tensor, frequencies: torch.Tensor,
                       n_samples: int, sample_rate: int) -> torch.Tensor:
    """resample + oscillator_bank: [B, F, K] controls -> [B, T] audio."""
    env_f, env_a = synth_envelopes_plain(amplitudes, frequencies, n_samples, sample_rate)
    return oscillator_bank(env_f, env_a, sample_rate)


@functools.lru_cache(maxsize=8)
def _tables(n_frames: int, n_samples: int, device: torch.device):
    """Per-sample bilinear taps (lo, frac) and the OLA hann window."""
    lo, _, frac = linear_taps(n_frames, n_samples, align_corners=False)
    hop = n_samples // n_frames
    return (torch.from_numpy(lo.astype(np.int32)).to(device),
            torch.from_numpy(frac).to(device),
            torch.from_numpy(hann_window(2 * hop)).to(device))


def _bind() -> ctypes.CDLL:
    lib = _build.load("synth")
    fn = lib.synth_forward_f32
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def synth_render(amplitudes: torch.Tensor, frequencies: torch.Tensor, n_samples: int,
                 sample_rate: int, debug_envelopes: bool = False):
    """[B, F, K] controls -> [B, n_samples] audio.

    With ``debug_envelopes`` (CUDA only) also returns the kernel's (env_f,
    env_a), each [B, T, K], for bit-equality checks against
    ``synth_envelopes_plain``.
    """
    if amplitudes.device.type == "cpu":
        if debug_envelopes:
            raise ValueError("synth_render: debug_envelopes is for the CUDA kernel")
        return synth_render_plain(amplitudes, frequencies, n_samples, sample_rate)
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
    if (n_samples % _THREADS or n_samples > _MAX_SAMPLES or n_frames > _MAX_FRAMES
            or n_frames < 2 or n_samples % n_frames):
        raise ValueError(
            f"synth_render: kernel covers n_samples % {_THREADS} == 0, n_samples <= "
            f"{_MAX_SAMPLES}, 2 <= n_frames <= {_MAX_FRAMES} and n_frames | n_samples; "
            f"got n_samples={n_samples}, n_frames={n_frames}")
    lo, frac, window = _tables(n_frames, n_samples, dev)
    lib = _bind()
    contrib = torch.empty((batch, n_sin, n_samples), dtype=torch.float32, device=dev)
    audio = torch.empty((batch, n_samples), dtype=torch.float32, device=dev)
    env_f = env_a = None
    if debug_envelopes:
        env_f = torch.empty_like(contrib)
        env_a = torch.empty_like(contrib)
    nyquist = float(np.float32(sample_rate / 2.0))
    omega_scale = float(np.float32(2.0 * math.pi / float(sample_rate)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.synth_forward_f32(
        amplitudes.data_ptr(), frequencies.data_ptr(), lo.data_ptr(), frac.data_ptr(),
        window.data_ptr(), contrib.data_ptr(), audio.data_ptr(),
        env_f.data_ptr() if debug_envelopes else None,
        env_a.data_ptr() if debug_envelopes else None,
        batch, n_frames, n_sin, n_samples, nyquist, omega_scale, stream)
    _build.check(err, "synth_forward_f32")
    global launches
    launches += 1
    if debug_envelopes:
        return audio, env_f.transpose(1, 2), env_a.transpose(1, 2)
    return audio
