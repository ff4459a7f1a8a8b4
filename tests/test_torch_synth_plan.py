"""Kernels 2 and 3's decomposition (``sot_tpu_torch/csrc/synth.cu``),
transcribed in numpy and held against the plain versions.

The forward splits each clip into 128-sample chunks (two warps each, four
consecutive samples per lane, four chunks to a block): a first launch sums
every chunk's f32 phase increments in float64 (each lane its four in order,
then the lanes), the second gives each chunk the earlier chunks' totals as
its carry, scans the lanes' sums, adds the lane's own increments in order
and rounds each phase once. The audio adds ``env_a * sin(phase)`` to an f32 accumulator in k
order from +0, skipping the samples at or above Nyquist. The backward owns
one (clip, harmonic) lane per block: runs of four samples at
``r * 4 * NT + 4 * i``, a float64 suffix of d_phase in the kernel's fixed
order (run sums last sample first, a shfl_down tree over the lanes, the
same tree over the warp totals, the rows summed from the last down), then
per-frame warp sums.

Tolerances: the forward's phase bit-equal to ``synth_phase_plain`` (float64
cumsum, rounded once: the increments' partial sums are exact, so every order
gives the same bits) and its audio bit-equal to a numpy k-order sum of the
plain envelopes times ``np.sin`` of that phase. The backward within 1e-5 of
the max of autograd through ``synth_render_plain`` (the same phase and
products; only the order of the float64 suffix and of the f32 frame sums
differs).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sot_tpu_torch.ops.kernels import synth as ksynth
from sot_tpu_torch.ops.numerics import exp_sigmoid

SR = 16000
CHUNK, LANES, SEG_CHUNKS = 128, 32, 4
BWD_MAX_NT = 512
SHAPES = [(16, 4096), (8, 1024), (32, 8192), (2, 256)]


def controls(seed: int, batch: int, n_frames: int, n_sin: int):
    """The smoke's controls: f0 33-2000 Hz, its harmonics (some at or above
    Nyquist), exp-sigmoid amplitudes masked at frame rate. numpy float32."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(33.0, 2000.0, (batch, n_frames, 1)).astype(np.float32)
    freqs = (f0 * np.arange(1, n_sin + 1, dtype=np.float32)).astype(np.float32)
    amps = exp_sigmoid(torch.from_numpy(
        rng.standard_normal((batch, n_frames, n_sin)).astype(np.float32))).numpy()
    amps = np.where(freqs >= SR / 2, np.float32(0), amps).astype(np.float32)
    return amps, freqs


def _envelopes(amps, freqs, n_samples):
    """The plain envelopes [B, K, T] (bit-equal to the kernels' on the card),
    the keep mask and the f32 increments."""
    env_f, env_a = (t.numpy().transpose(0, 2, 1) for t in ksynth.synth_envelopes_plain(
        torch.from_numpy(amps), torch.from_numpy(freqs), n_samples, SR))
    nyquist, omega = (np.float32(v) for v in ksynth._scalars(SR))
    return env_f, env_a, env_f < nyquist, (env_f * omega).astype(np.float32)


def lane_excl_scan(own: np.ndarray) -> np.ndarray:
    """The kernels' shfl_up scan over the last axis (32 lanes): exclusive."""
    incl = own.copy()
    for d in (1, 2, 4, 8, 16):
        shifted = np.zeros_like(incl)
        shifted[..., d:] = incl[..., :-d]
        incl = incl + shifted
    excl = np.zeros_like(incl)
    excl[..., 1:] = incl[..., :-1]
    return excl


def lane_suffix_scan(own: np.ndarray):
    """The backward's shfl_down scan over the last axis (32 lanes): the
    inclusive and the exclusive suffix, tree order."""
    incl = own.copy()
    for d in (1, 2, 4, 8, 16):
        shifted = np.zeros_like(incl)
        shifted[..., :-d] = incl[..., d:]
        incl = incl + shifted
    excl = np.zeros_like(incl)
    excl[..., :-1] = incl[..., 1:]
    return incl, excl


def butterfly(v: np.ndarray, width: int = LANES) -> np.ndarray:
    """__shfl_xor_sync reduction over the last axis (``width`` lanes); lane
    0's value."""
    d = width // 2
    while d:
        v = v + v[..., np.arange(width) ^ d]
        d //= 2
    return v[..., 0]


def phase_totals(inc: np.ndarray) -> np.ndarray:
    """synth_phase_totals_kernel: [B, K, T] increments -> [B, K, T/128]
    float64 chunk totals (a lane's four in order, then the butterfly)."""
    b, k, t = inc.shape
    runs = inc.reshape(b, k, t // CHUNK, LANES, 4).astype(np.float64)
    own = np.zeros(runs.shape[:-1])
    for q in range(4):
        own = own + runs[..., q]
    return butterfly(own)


def forward_phase(inc: np.ndarray) -> np.ndarray:
    """synth_fwd_kernel's phase [B, K, T] (f32): each chunk's carry (the
    totals before its 4-chunk segment, lane g of 8 adding chunks g, g + 8,
    ..., then the butterfly; then the segment's earlier chunks in order), the
    lanes' exclusive scan, the lane's own increments in order, rounded once.
    Every partial sum is exact, so the transcription may group them as it
    likes and still must give the same bits."""
    b, k, t = inc.shape
    n_chunks = t // CHUNK
    totals = phase_totals(inc)
    carry = np.zeros_like(totals)
    for c in range(n_chunks):
        c0 = c - c % SEG_CHUNKS
        lanes = np.zeros((b, k, 8))
        for cc in range(c0):
            lanes[..., cc % 8] = lanes[..., cc % 8] + totals[..., cc]
        carry[..., c] = butterfly(lanes, 8)
        for cc in range(c0, c):
            carry[..., c] = carry[..., c] + totals[..., cc]
    runs = inc.reshape(b, k, n_chunks, LANES, 4).astype(np.float64)
    own = np.zeros(runs.shape[:-1])
    for q in range(4):
        own = own + runs[..., q]
    run = carry[..., None] + lane_excl_scan(own)
    phase = np.empty(runs.shape, np.float32)
    for q in range(4):
        run = run + runs[..., q]
        phase[..., q] = run.astype(np.float32)
    return phase.reshape(b, k, t)


def forward_transcription(amps, freqs, n_samples):
    """(audio [B, T], phase [B, K, T]) as synth_fwd_kernel computes them,
    with np.sin for sinf: the harmonics added in k order from +0 where the
    sample is below Nyquist (a chunk whose samples are all at or above it
    skips the harmonic)."""
    _, env_a, keep, inc = _envelopes(amps, freqs, n_samples)
    phase = forward_phase(inc)
    b, k, t = inc.shape
    chunk_live = keep.reshape(b, k, t // CHUNK, CHUNK).any(-1)
    audio = np.zeros((b, t), np.float32)
    for kk in range(k):
        live = np.repeat(chunk_live[:, kk], CHUNK, axis=1) & keep[:, kk]
        term = (env_a[:, kk] * np.sin(phase[:, kk])).astype(np.float32)
        audio = np.where(live, (audio + term).astype(np.float32), audio)
    return audio, phase


def _block_geometry(n_samples: int):
    nt = min(BWD_MAX_NT, n_samples // 4)
    rows = -(-n_samples // (4 * nt))
    return nt, {1: 1, 2: 2}.get(rows, 4)


def _warp_strided_sum(vals: np.ndarray, start: int, end: int) -> np.ndarray:
    """A warp's f32 sum of vals[..., start:end]: lane l adds start + l,
    start + l + 32, ... in order, then the butterfly."""
    n = end - start
    m = -(-n // LANES)
    padded = np.zeros(vals.shape[:-1] + (m * LANES,), np.float32)
    padded[..., :n] = vals[..., start:end]
    padded = padded.reshape(vals.shape[:-1] + (m, LANES))
    acc = np.zeros(vals.shape[:-1] + (LANES,), np.float32)
    for i in range(m):
        acc = (acc + padded[..., i, :]).astype(np.float32)
    return butterfly(acc).astype(np.float32)


def backward_transcription(amps, freqs, dout, n_samples):
    """synth_bwd_kernel in numpy: (d amplitudes, d frequencies), [B, F, K]."""
    b, n_frames, k = amps.shape
    _, frac, window, lo_start, hi_start = (t.numpy() for t in ksynth._tables(
        n_frames, n_samples, torch.device("cpu")))
    _, omega = (np.float32(v) for v in ksynth._scalars(SR))
    hop = n_samples // n_frames
    _, env_a, keep, inc = _envelopes(amps, freqs, n_samples)
    phase = forward_phase(inc)  # exact, so the runs' scan gives the same bits
    g = dout[:, None, :]
    s, co = np.sin(phase), np.cos(phase)
    da = np.where(keep, (g * s).astype(np.float32), np.float32(0))
    dph = np.where(keep, ((g * env_a).astype(np.float32) * co).astype(np.float32),
                   np.float32(0))

    nt, rows = _block_geometry(n_samples)
    nw = nt // LANES
    pad = rows * 4 * nt - n_samples
    runs = np.concatenate([dph, np.zeros((b, k, pad), np.float32)], -1)
    runs = runs.reshape(b, k, rows, nw, LANES, 4).astype(np.float64)
    own = runs[..., 3]
    for q in (2, 1, 0):
        own = own + runs[..., q]
    incl, excl = lane_suffix_scan(own)
    warps = np.zeros(own.shape[:-2] + (LANES,))  # warp totals, 0 past the last warp
    warps[..., :nw] = incl[..., 0]
    rows_incl, rows_excl = lane_suffix_scan(warps)  # warp 0's tree over the warp totals
    base = np.zeros(own.shape)
    later_rows = np.zeros((b, k))
    for r in range(rows - 1, -1, -1):
        base[:, :, r] = (later_rows[..., None] + rows_excl[:, :, r, :nw])[..., None] + excl[:, :, r]
        later_rows = later_rows + rows_incl[:, :, r, 0]
    d_env_f = np.empty(runs.shape, np.float32)
    suf = base
    for q in (3, 2, 1, 0):
        suf = suf + runs[..., q]
        d_env_f[..., q] = (suf.astype(np.float32) * omega).astype(np.float32)
    d_env_f = d_env_f.reshape(b, k, -1)[..., :n_samples]

    d_amps = np.zeros_like(amps)
    d_freqs = np.zeros_like(freqs)
    lo_part = (d_env_f - (frac * d_env_f).astype(np.float32)).astype(np.float32)
    hi_part = (frac * d_env_f).astype(np.float32)
    fall = (window[hop:][np.arange(n_samples) % hop] * da).astype(np.float32)
    rise = (window[:hop][np.arange(n_samples) % hop] * da).astype(np.float32)
    for f in range(n_frames):
        d_freqs[:, f] = (_warp_strided_sum(lo_part, lo_start[f], lo_start[f + 1])
                         + _warp_strided_sum(hi_part, hi_start[f], hi_start[f + 1]))
        acc = _warp_strided_sum(fall, f * hop, (f + 1) * hop)
        acc = acc + (_warp_strided_sum(rise, (f - 1) * hop, f * hop) if f > 0 else 0)
        if f == n_frames - 1:
            acc = acc + _warp_strided_sum(rise, f * hop, (f + 1) * hop)
        d_amps[:, f] = acc
    return d_amps, d_freqs


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n_sin", [1, 3, 20])
@pytest.mark.parametrize("n_frames,n_samples", SHAPES)
def test_forward_decomposition_bit_equal_to_plain(n_frames, n_samples, n_sin):
    amps, freqs = controls(n_frames * 7 + n_sin, 2, n_frames, n_sin)
    audio, phase = forward_transcription(amps, freqs, n_samples)
    env_f, env_a = ksynth.synth_envelopes_plain(torch.from_numpy(amps),
                                                torch.from_numpy(freqs), n_samples, SR)
    ref_phase = ksynth.synth_phase_plain(env_f, SR).numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(phase, ref_phase)
    # every harmonic's term added in k order from +0, masked ones included
    env_a = env_a.numpy().transpose(0, 2, 1)
    ref = np.zeros((2, n_samples), np.float32)
    for kk in range(n_sin):
        ref = (ref + (env_a[:, kk] * np.sin(ref_phase[:, kk])).astype(np.float32)
               ).astype(np.float32)
    np.testing.assert_array_equal(audio, ref)
    plain = ksynth.synth_render_plain(torch.from_numpy(amps), torch.from_numpy(freqs),
                                      n_samples, SR).numpy()
    assert np.abs(audio - plain).max() <= 1e-5 * max(1.0, np.abs(plain).max())


@pytest.mark.parametrize("n_sin", [1, 3, 20])
@pytest.mark.parametrize("n_frames,n_samples", SHAPES)
def test_backward_decomposition_matches_autograd_of_plain(n_frames, n_samples, n_sin):
    amps, freqs = controls(n_frames * 11 + n_sin, 2, n_frames, n_sin)
    dout = np.random.default_rng(n_samples).standard_normal((2, n_samples)).astype(np.float32)
    a = torch.from_numpy(amps).requires_grad_(True)
    f = torch.from_numpy(freqs).requires_grad_(True)
    torch.sum(ksynth.synth_render_plain(a, f, n_samples, SR) * torch.from_numpy(dout)).backward()
    ta, tf = backward_transcription(amps, freqs, dout, n_samples)
    assert _rel(ta, a.grad.numpy()) <= 1e-5
    assert _rel(tf, f.grad.numpy()) <= 1e-5


@pytest.mark.parametrize("n_samples", [4096, 8192])
def test_phase_sum_is_exact_in_any_order(n_samples):
    """The f32 increments of harmonics over the smoke's ranges (f0 33-2000
    Hz, 20 harmonics, those above Nyquist included) summed in float64
    serially, in a random order and in the kernel's split: bit-equal totals,
    and the serial prefixes equal to the kernel's at every sample."""
    amps, freqs = controls(n_samples, 4, 16, 20)
    env_f, _, keep, inc = _envelopes(amps, freqs, n_samples)
    assert 0.0 < keep.mean() < 1.0
    assert float(inc.min()) >= 2.0 ** -7  # the premise: multiples of 2^-30
    serial = np.cumsum(inc.astype(np.float64), axis=-1)
    assert float(serial.max()) < 2.0 ** 18
    order = np.random.default_rng(1).permutation(n_samples)
    shuffled = np.cumsum(inc[..., order].astype(np.float64), axis=-1)[..., -1]
    totals = phase_totals(inc)
    split = np.zeros(totals.shape[:-1])
    for c in range(totals.shape[-1]):
        split = split + totals[..., c]
    np.testing.assert_array_equal(serial[..., -1], shuffled)
    np.testing.assert_array_equal(serial[..., -1], split)
    np.testing.assert_array_equal(forward_phase(inc), serial.astype(np.float32))


@pytest.mark.parametrize("n_samples", [256, 768, 1792, 4096, 6144, 8192])
def test_tilings_cover_every_sample_once(n_samples):
    """The forward's (chunk, lane, q) and the backward's (row, thread, q)
    maps hit each sample of the clip exactly once; the rest of the last
    backward row is idle."""
    t = (np.arange(n_samples // CHUNK)[:, None, None] * CHUNK
         + 4 * np.arange(LANES)[None, :, None] + np.arange(4)).ravel()
    np.testing.assert_array_equal(np.sort(t), np.arange(n_samples))
    nt, rows = _block_geometry(n_samples)
    assert nt % LANES == 0 and nt <= BWD_MAX_NT and rows * 4 * nt >= n_samples
    t = (np.arange(rows)[:, None, None] * 4 * nt + 4 * np.arange(nt)[None, :, None]
         + np.arange(4)).ravel()
    np.testing.assert_array_equal(np.sort(t[t < n_samples]), np.arange(n_samples))
