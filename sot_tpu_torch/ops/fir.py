"""FIR filtering by frequency sampling and blockwise FFT convolution (L1),
port of ``sot_tpu/ops/fir.py``:

  * ``frequency_impulse_response`` — a zero-phase IR from a one-sided
    magnitude response: irfft, then a hann window
  * ``fft_convolve`` — time-varying blockwise convolution with overlap-add
    (power-of-2 FFT sizes), an optional sin^2/cos^2 cross-fade between IR
    frames
  * ``crop_and_compensate_delay`` — the group-delay compensation crop
  * ``slope_frequency_response`` — the -X dB/octave roll-off curve of the
    MSS-LogLin experiment's synth

Plain PyTorch on ``torch.fft`` (the JAX package computes this in XLA, not
in a Pallas kernel), float32 throughout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sot_tpu_torch.device import device_constant
from sot_tpu_torch.ops.windows import hann_window


def apply_window_to_impulse_response(impulse_response: torch.Tensor, window_size: int = 0,
                                     causal: bool = False) -> torch.Tensor:
    """Hann-window an IR around its zero-phase peak; return the causal form.

    The alignment is two host constants, a zero-phase-aligned window and a
    causal reorder, so the device work is one multiply and one gather (the
    asymmetric crop offsets are the reference's, as in the JAX package).
    """
    ir = torch.as_tensor(impulse_response, dtype=torch.float32)
    batch_only = ir.ndim == 2
    if batch_only:
        ir = ir[:, None, :]
    n = ir.shape[-1]
    if causal:  # input given in causal form: rotate the peak to index 0
        ir = torch.roll(ir, n // 2, dims=-1)

    w = window_size if 0 < window_size <= n else n
    head = (w + 1) // 2  # taps on the peak side of the zero-phase IR
    win = hann_window(w)
    if w < n:
        win_zp = np.concatenate([win[head:], np.zeros(n - w, np.float32), win[:head]])
        order = np.concatenate([np.arange(n - head + 2, n), np.arange(head + 1)])
    else:
        win_zp = np.roll(win, n // 2)
        order = (np.arange(n) - n // 2) % n

    out = ir * device_constant(win_zp, ir.device)[None, None, :]
    out = out[..., device_constant(order, ir.device)]
    return out[:, 0, :] if batch_only else out


def frequency_impulse_response(magnitudes: torch.Tensor, window_size: int = 0) -> torch.Tensor:
    """One-sided magnitude response -> windowed zero-phase FIR."""
    impulse_response = torch.fft.irfft(torch.as_tensor(magnitudes, dtype=torch.float32), dim=-1)
    return apply_window_to_impulse_response(impulse_response, window_size)


def get_fft_size(frame_size: int, ir_size: int) -> int:
    """Next power of 2 >= frame_size + ir_size - 1."""
    convolved = ir_size + frame_size - 1
    return int(2 ** math.ceil(math.log2(convolved)))


def crop_and_compensate_delay(audio: torch.Tensor, audio_size: int, ir_size: int,
                              padding: str, delay_compensation: int) -> torch.Tensor:
    """Crop convolved audio to compensate the linear-phase group delay."""
    if padding == "valid":
        crop_size = ir_size + audio_size - 1
    elif padding == "same":
        crop_size = audio_size
    else:
        raise ValueError(f"Padding must be 'valid' or 'same', instead of {padding}.")
    total_size = audio.shape[-1]
    crop = total_size - crop_size
    start = (ir_size - 1) // 2 - 1 if delay_compensation < 0 else delay_compensation
    end = crop - start
    return audio[:, start:total_size - end]


def _cross_fade_frames(frames: torch.Tensor, frames_prev: torch.Tensor,
                       overlap: int) -> torch.Tensor:
    """sin^2/cos^2 cross-fade between each frame's own-IR and previous-IR
    convolutions (the first frame gets no fade)."""
    n = frames.shape[-1]
    ramp = np.linspace(0.0, float(overlap), overlap, dtype=np.float32)
    fade_in = np.ones(n, np.float32)
    fade_in[:overlap] = np.sin(np.pi * ramp / (2.0 * overlap)) ** 2
    fade_out = np.zeros(n, np.float32)
    fade_out[:overlap] = np.cos(np.pi * ramp / (2.0 * overlap)) ** 2
    n_frames = frames.shape[1]
    fade_in_full = np.concatenate([np.ones((1, n), np.float32),
                                   np.broadcast_to(fade_in, (n_frames - 1, n))])[None]
    fade_out_full = np.concatenate([np.zeros((1, n), np.float32),
                                    np.broadcast_to(fade_out, (n_frames - 1, n))])[None]
    dev = frames.device
    return (frames * device_constant(fade_in_full, dev)
            + frames_prev * device_constant(fade_out_full, dev))


def fft_convolve(audio: torch.Tensor, impulse_response: torch.Tensor, padding: str = "same",
                 delay_compensation: int = -1, cross_fade: bool = False) -> torch.Tensor:
    """Blockwise (time-varying) FFT convolution with overlap-add.

    Args:
      audio: [batch, T].
      impulse_response: [batch, ir_size] (LTI) or [batch, n_frames, ir_size]
        (time-varying; the audio is cut into n_frames equal blocks).
    """
    audio = torch.as_tensor(audio, dtype=torch.float32)
    impulse_response = torch.as_tensor(impulse_response, dtype=torch.float32)
    if impulse_response.ndim == 2:
        impulse_response = impulse_response[:, None, :]
    batch_size_ir, n_ir_frames, ir_size = impulse_response.shape
    batch_size, audio_size = audio.shape
    if batch_size != batch_size_ir:
        raise ValueError(f"Batch size of audio ({batch_size}) and impulse response "
                         f"({batch_size_ir}) must be the same.")

    frame_size = -(-audio_size // n_ir_frames)  # ceil
    pad_tail = frame_size * n_ir_frames - audio_size
    if pad_tail:
        audio = torch.nn.functional.pad(audio, (0, pad_tail))
    audio_frames = audio.reshape(batch_size, n_ir_frames, frame_size)

    fft_size = get_fft_size(frame_size, ir_size)
    audio_fft = torch.fft.rfft(audio_frames, n=fft_size, dim=-1)
    ir_fft = torch.fft.rfft(impulse_response, n=fft_size, dim=-1)

    if cross_fade:
        frames_own = torch.fft.irfft(audio_fft * ir_fft, n=fft_size, dim=-1)
        frames_prev = torch.fft.irfft(audio_fft * torch.roll(ir_fft, 1, dims=1), n=fft_size,
                                      dim=-1)
        audio_frames_out = _cross_fade_frames(frames_own, frames_prev, ir_size - 1)
    else:
        audio_frames_out = torch.fft.irfft(audio_fft * ir_fft, n=fft_size, dim=-1)

    # overlap-add at stride frame_size: frame k covers [k*frame_size, k*frame_size
    # + fft_size); its chunks of frame_size add along anti-diagonals
    n_chunks = -(-fft_size // frame_size)
    pad_to = n_chunks * frame_size - fft_size
    if pad_to:
        audio_frames_out = torch.nn.functional.pad(audio_frames_out, (0, pad_to))
    chunks = audio_frames_out.reshape(batch_size, n_ir_frames, n_chunks, frame_size)
    out_len_frames = n_ir_frames + n_chunks - 1
    acc = audio_frames_out.new_zeros((batch_size, out_len_frames, frame_size))
    for c in range(n_chunks):
        acc = acc + torch.nn.functional.pad(chunks[:, :, c, :],
                                            (0, 0, c, out_len_frames - n_ir_frames - c))
    audio_out = acc.reshape(batch_size, out_len_frames * frame_size)
    audio_out_size = (n_ir_frames - 1) * frame_size + fft_size
    audio_out = audio_out[:, :audio_out_size]
    return crop_and_compensate_delay(audio_out, audio_size, ir_size, padding,
                                     delay_compensation)


def frequency_filter(audio: torch.Tensor, magnitudes: torch.Tensor, window_size: int = 0,
                     padding: str = "same", cross_fade: bool = False) -> torch.Tensor:
    """Filter audio with an FIR built from a magnitude response."""
    impulse_response = frequency_impulse_response(magnitudes, window_size=window_size)
    return fft_convolve(audio, impulse_response, padding=padding, cross_fade=cross_fade)


def slope_frequency_response(decay_per_octave_db: float, n_freqs: int,
                             f_ref: float) -> torch.Tensor:
    """-X dB/octave amplitude roll-off above f_ref over [0, 8000] Hz,
    [1, 1, n_freqs] float32."""
    decay = torch.as_tensor(decay_per_octave_db, dtype=torch.float32)
    freqs = np.linspace(0.0, 8000.0, n_freqs, dtype=np.float32)
    freqs[0] += 1e-7
    freqs = torch.from_numpy(freqs)[None, None, :]
    a_0 = 10.0 ** (-decay / 20.0)
    return torch.where(freqs > f_ref, a_0 ** torch.log2(freqs / f_ref), torch.ones(()))
