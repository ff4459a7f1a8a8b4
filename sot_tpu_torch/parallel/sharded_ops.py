"""Explicitly sharded DSP ops on ``torch.distributed``, port of
``sot_tpu/parallel/sharded_ops.py``.

Each function takes this rank's local block and the mesh and returns the
local block of the output:

* ``stft_magnitude_frame_sharded`` — the audio's time axis split over the
  mesh's 'freq' axis; each rank frames its own chunk after receiving its
  right neighbours' first ``n_fft - hop`` samples (the halo; it may span
  several chunks), zeros past the signal's end (``pad_end``). Its frames
  come back: [batch, frames / n, bins].
* ``wasserstein_same_grid_row_sharded`` — rows (batch x frames) split over
  both axes need no collective: each rank solves its own rows on the route
  of its kernel gates, so the name is ``ops/wasserstein.
  wasserstein_same_grid`` itself.
* ``oscillator_bank_sample_sharded`` — the synth's sample axis split over
  'freq'; each rank accumulates its chunk's phase (``angular_cumsum``), the
  chunk end phases are all-gathered, and the masked exclusive sum mod 2pi
  is the rank's carry: the cross-rank form of ``angular_cumsum``'s chunk
  stitching.
* ``wasserstein_1d_freq_sharded`` — bins split over 'freq', rows over
  'data'; the rank all-gathers the grid and its rows' weights along
  'freq', then solves its rows.

The one collective is ``all_gather``, an autograd function whose backward
is its transpose: the cotangents of the gathered blocks are summed over the
group and each rank keeps its own block's (a halo's cotangent goes back to
the rank that owns those samples). Every rank of the group uses the whole
gathered tensor in its graph, so every rank runs that backward and the
collectives stay matched.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from sot_tpu_torch.ops.oscillator import angular_cumsum, remove_above_nyquist
from sot_tpu_torch.ops.stft import stft_magnitude
from sot_tpu_torch.ops.wasserstein import wasserstein_1d, wasserstein_same_grid
from sot_tpu_torch.parallel.mesh import Mesh

_TWO_PI = 2.0 * math.pi


class _AllGather(torch.autograd.Function):
    """[...] on each of the group's n ranks -> [n, ...], the blocks in rank
    order; backward: the [n, ...] cotangent summed over the group, this
    rank's block kept (the transpose of the gather)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x, group=group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[dist.get_rank(ctx.group)], None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` of every rank along the mesh ``axis``, stacked: [n, ...]."""
    return _AllGather.apply(x, mesh.group(axis))


def stft_magnitude_frame_sharded(audio: torch.Tensor, mesh: Mesh, size: int = 2048,
                                 hop_length: int = 256, window: Optional[str] = None,
                                 axis: str = "freq") -> torch.Tensor:
    """Frame-sharded magnitude STFT over ``mesh[axis]``.

    audio: this rank's chunk [batch, T / n] of [batch, T] audio, T divisible
    by hop * n. Returns this rank's frames [batch, T / (hop * n), size//2+1]
    of ``stft_magnitude(..., pad_end=True, normalized=True)`` of the whole
    signal (rfft, as the JAX package's op; never the frontend kernel)."""
    n = mesh.shape[axis]
    chunk = audio.shape[-1]
    if chunk % hop_length != 0:
        raise ValueError(f"T={chunk * n} must be divisible by hop*n_shards={hop_length * n}")
    halo = size - hop_length
    take = min(halo, chunk)  # each rank's head: the halo needs at most ceil(halo / chunk) chunks
    heads = all_gather(audio[..., :take], mesh, axis)  # [n, batch, take]
    zeros = audio.new_zeros(audio.shape[:-1] + (halo,))  # past the end: pad_end
    stream = torch.cat([heads.movedim(0, -2).flatten(-2), zeros], dim=-1)
    start = (mesh.coords[axis] + 1) * take
    ext = torch.cat([audio, stream[..., start:start + halo]], dim=-1)
    return stft_magnitude(ext, size=size, overlap=1.0 - hop_length / size, window=window,
                          pad_end=False)


# Same-grid W_p^p of this rank's rows [rows / n, bins] of weights whose rows
# are split over the whole mesh -> [rows / n]. Rows are independent, so the
# single-device solve on the rank's block is the sharded solve (on the
# SOT-2048 rows under ``auto``, kernels B4 + B5, which compute each row apart
# from its neighbours).
wasserstein_same_grid_row_sharded = wasserstein_same_grid


def oscillator_bank_sample_sharded(frequency_envelopes: torch.Tensor,
                                   amplitude_envelopes: torch.Tensor, mesh: Mesh,
                                   sample_rate: int = 16000,
                                   axis: str = "freq") -> torch.Tensor:
    """Sample-sharded sinusoidal oscillator bank with a cross-rank phase
    carry: ``oscillator_bank(..., use_angular_cumsum=True)`` of the whole
    signal, its phase stitched mod 2pi at the ranks' chunk boundaries.

    Inputs: this rank's chunk [batch, T / n, n_sinusoids] of the sample
    axis. The carry is the earlier ranks' chunk end phases summed in
    float64 and rounded once to f32, then taken mod 2pi, as
    ``angular_cumsum`` carries its chunks (``ops/scan.prefix_sum``).
    Returns [batch, T / n]."""
    n = mesh.shape[axis]
    amplitude_envelopes = remove_above_nyquist(frequency_envelopes, amplitude_envelopes,
                                               sample_rate)
    omega = frequency_envelopes.to(torch.float32) * (_TWO_PI / float(sample_rate))
    local_phase = angular_cumsum(omega)  # in [0, 2pi): the exchanged totals stay small
    totals = all_gather(local_phase[:, -1:, :], mesh, axis)  # [n, batch, 1, n_sin]
    earlier = torch.arange(n, device=totals.device) < mesh.coords[axis]
    carry = (totals.to(torch.float64) * earlier.to(torch.float64)[:, None, None, None]).sum(0)
    carry = torch.remainder(carry.to(torch.float32), _TWO_PI)
    phase = torch.remainder(local_phase + carry, _TWO_PI)
    return torch.sum(amplitude_envelopes * torch.sin(phase), dim=-1)


def wasserstein_1d_freq_sharded(grid: torch.Tensor, u_weights: torch.Tensor,
                                v_weights: torch.Tensor, mesh: Mesh, p: float = 1,
                                limit_quantile_range: bool = False,
                                freq_axis: str = "freq") -> torch.Tensor:
    """Same-grid W_p^p of weights [rows, bins] split (rows over 'data',
    bins over ``freq_axis``): this rank's grid block [bins / n] and weight
    block [rows / d, bins / n] -> its rows' W [rows / d]. The grid and the
    weights are all-gathered along ``freq_axis``, then
    ``wasserstein_1d(..., require_sort=False)`` solves the rows."""
    g_full = all_gather(grid.to(torch.float32), mesh, freq_axis).flatten()
    u_full = all_gather(u_weights, mesh, freq_axis).movedim(0, -2).flatten(-2)
    v_full = all_gather(v_weights, mesh, freq_axis).movedim(0, -2).flatten(-2)
    g_rows = g_full[None, :].expand(u_full.shape)
    return wasserstein_1d(g_rows, g_rows, u_weights=u_full, v_weights=v_full, p=p,
                          require_sort=False, limit_quantile_range=limit_quantile_range)
