"""Evaluation metrics (L4), port of ``sot_tpu/metrics.py``: LSD, MSE, MSS,
RPA, RCA, octave difference, W1/W2.

  * pitch accuracies with mir_eval.melody semantics (hz2cents from a 10 Hz
    base, 50-cent tolerance, octave folding for chroma), on the device
  * LSD = L2 of 10*log10(mag^2) at n_fft = 1024 (the checkpoint-selection
    metric)
  * MSS metric = six-scale magnitude + log-magnitude L1
  * signed mean octave difference with the 50-cent guard
  * W1/W2 spectral distance at n_fft = 512 on a fixed linspace support
  * the unsupervised pitch corrections ``octave_correct_pitch`` and
    ``comb_correct_pitch``: clip-level factors read off the input's
    spectrum (the JAX package's float32 arithmetic: ``jnp.median``'s
    midpoint of the two middle frames, round half to even, truncation to
    int32, the first of equal scores)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sot_tpu_torch.device import device_constant
from sot_tpu_torch.losses import Wasserstein1D, mean_difference
from sot_tpu_torch.ops.numerics import safe_log, safe_log10
from sot_tpu_torch.ops.stft import stft_magnitude


def mse(x: torch.Tensor, x_hat: torch.Tensor, sort: bool = False) -> torch.Tensor:
    if sort:
        x = torch.sort(x, dim=-1).values
        x_hat = torch.sort(x_hat, dim=-1).values
    return mean_difference(x, x_hat, "L2")


def ms_spectral_distance(target_audio: torch.Tensor, audio: torch.Tensor,
                         fft_sizes: Sequence[int], mag_weight: float = 1.0,
                         logmag_weight: float = 1.0,
                         log_spectral_distance_weight: float = 0.0,
                         loss_type: str = "L1") -> torch.Tensor:
    """Multi-scale spectral distance with an LSD option."""
    loss = 0.0
    for size in fft_sizes:
        target_mag = stft_magnitude(target_audio, size=size, overlap=0.75)
        value_mag = stft_magnitude(audio, size=size, overlap=0.75)
        if mag_weight > 0:
            loss = loss + mag_weight * mean_difference(target_mag, value_mag, loss_type)
        if logmag_weight > 0:
            loss = loss + logmag_weight * mean_difference(
                safe_log(target_mag), safe_log(value_mag), loss_type)
        if log_spectral_distance_weight > 0:
            t = 10.0 * safe_log10(target_mag ** 2)
            v = 10.0 * safe_log10(value_mag ** 2)
            loss = loss + log_spectral_distance_weight * mean_difference(t, v, loss_type)
    return loss


def log_spectral_distance(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """The checkpoint-selection metric: LSD at n_fft = 1024, L2."""
    return ms_spectral_distance(x, x_hat, fft_sizes=[1024], mag_weight=0.0, logmag_weight=0.0,
                                log_spectral_distance_weight=1.0, loss_type="L2")


def hz_to_cents(freq_hz: torch.Tensor, base_frequency: float = 10.0) -> torch.Tensor:
    """mir_eval.melody.hz2cents: 1200*log2(f/base); 0 for non-positive."""
    freq_hz = torch.as_tensor(freq_hz, dtype=torch.float32)
    voiced = freq_hz > 0
    cents = 1200.0 * torch.log2(torch.where(voiced, freq_hz, 1.0) / base_frequency)
    return torch.where(voiced, cents, 0.0)


def raw_pitch_accuracy(pred_hz: torch.Tensor, true_hz: torch.Tensor,
                       cent_tolerance: float = 50.0) -> torch.Tensor:
    """Fraction of frames within the cent tolerance (all frames voiced)."""
    diff = hz_to_cents(true_hz) - hz_to_cents(pred_hz)
    return torch.mean((torch.abs(diff) <= cent_tolerance).to(torch.float32))


def raw_chroma_accuracy(pred_hz: torch.Tensor, true_hz: torch.Tensor,
                        cent_tolerance: float = 50.0) -> torch.Tensor:
    """Octave-folded pitch accuracy (mir_eval.melody.raw_chroma_accuracy)."""
    diff = hz_to_cents(true_hz) - hz_to_cents(pred_hz)
    folded = torch.abs(diff - 1200.0 * torch.round(diff / 1200.0))
    return torch.mean((folded <= cent_tolerance).to(torch.float32))


def mean_octave_difference(pred_hz: torch.Tensor, true_hz: torch.Tensor) -> torch.Tensor:
    """Signed mean octave error with a 50-cent half-semitone guard (voicing
    all ones, cents of 0 Hz excluded)."""
    ref_cent = hz_to_cents(true_hz).reshape(-1)
    est_cent = hz_to_cents(pred_hz).reshape(-1)
    nonzero = (est_cent != 0) & (ref_cent != 0)
    diff = ref_cent - est_cent
    sign = torch.sign(diff)
    oct_diff = torch.floor(torch.abs(diff + 50.0 * sign) / 1200.0)
    num = torch.sum(torch.where(nonzero, oct_diff * sign, 0.0))
    return torch.where(nonzero.any(), num / ref_cent.shape[0], 0.0)


def _clip_spectrum(x: torch.Tensor, n_fft: int, frontend: bool) -> torch.Tensor:
    """[b, T] -> the frame mean [b, n_fft // 2 + 1] of the Hann magnitude
    STFT at 75% overlap (kernel 9 with ``frontend``, where it applies)."""
    return stft_magnitude(x, size=n_fft, overlap=0.75, frontend=frontend).mean(dim=1)


def _median_frames(pitch_hz: torch.Tensor) -> torch.Tensor:
    """[b, frames, 1] -> [b]: ``jnp.median`` over the frames (the midpoint
    (lo + hi) * 0.5 of the two middle values, NaN where a frame is NaN)."""
    p = pitch_hz[:, :, 0]
    srt = torch.sort(p, dim=1).values
    n = p.shape[1]
    mid = (srt[:, (n - 1) // 2] + srt[:, n // 2]) * 0.5
    return torch.where(torch.isnan(p).any(dim=1), float("nan"), mid)


def _band_peak(spec: torch.Tensor, freq: torch.Tensor, df: float) -> torch.Tensor:
    """The largest magnitude of spec [b, bins] within +-2% (at least one
    bin) of each frequency freq [b, ...] in Hz."""
    b, n_bins = spec.shape
    max_halfwidth = max(1, int(0.02 * (n_bins - 1)))  # full +-2% at Nyquist
    offsets = torch.arange(-max_halfwidth, max_halfwidth + 1, device=spec.device)
    idx = torch.round(freq.reshape(b, -1) / df).to(torch.int32)
    take = torch.clamp(idx[..., None] + offsets, 0, n_bins - 1)
    vals = torch.gather(spec, 1, take.reshape(b, -1).long()).reshape(take.shape)
    halfwidth = torch.clamp((0.02 * idx).to(torch.int32), min=1)
    mask = offsets.abs() <= halfwidth[..., None]
    return torch.where(mask, vals, 0.0).amax(dim=-1).reshape(freq.shape)


def octave_factors(x: torch.Tensor, pitch_hz: torch.Tensor, sample_rate: float = 16000,
                   n_fft: int = 2048, rel_threshold: float = 0.1,
                   down_threshold: float = 0.25, max_shifts: int = 3,
                   min_frequency_hz: float = 38.0, frontend: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``octave_correct_pitch``'s clip factors [b] and the quantities its
    decisions compare: the median pitch ``f0``, the spectrum's
    ``global_peak``, and per round the band peak at the fundamental
    (``up``, against rel_threshold x global_peak) and at half of it
    (``down``, against down_threshold x global_peak)."""
    spec = _clip_spectrum(x, n_fft, frontend)
    df = sample_rate / n_fft
    f0 = _median_frames(pitch_hz)
    factor = torch.ones_like(f0)
    nyquist = sample_rate / 2.0
    global_peak = spec.amax(dim=-1)
    up, down = [], []
    # octave-DOWN errors: the predicted fundamental band is empty -> up
    for _ in range(max_shifts):
        cur = f0 * factor
        up.append(_band_peak(spec, cur, df))
        shift = (up[-1] < rel_threshold * global_peak) & (2.0 * cur < nyquist)
        factor = torch.where(shift, factor * 2.0, factor)
    # octave-UP errors: strong energy below the fundamental -> down
    for _ in range(max_shifts):
        cur = f0 * factor
        down.append(_band_peak(spec, 0.5 * cur, df))
        shift = (down[-1] > down_threshold * global_peak) & (0.5 * cur >= min_frequency_hz)
        factor = torch.where(shift, factor * 0.5, factor)
    return factor, {"f0": f0, "global_peak": global_peak, "up": torch.stack(up),
                    "down": torch.stack(down)}


def octave_correct_pitch(x: torch.Tensor, pitch_hz: torch.Tensor, **kwargs) -> torch.Tensor:
    """Unsupervised test-time octave disambiguation
    (``sot_tpu/metrics.py:octave_correct_pitch``): while the input's
    magnitude in a +-2% band at the clip's median pitch is under
    rel_threshold x its spectral peak, double the pitch; then, while the
    band at half the pitch holds more than down_threshold x the peak (and
    half stays >= min_frequency_hz), halve it. x [b, T], pitch_hz [b,
    frames, 1]; keyword arguments as ``octave_factors``."""
    factor, _ = octave_factors(x, pitch_hz, **kwargs)
    return pitch_hz * factor[:, None, None]


_COMB_RATIOS = (1.0, 2.0, 3.0, 4.0, 0.5, 1.0 / 3.0, 0.25,
                2.0 / 3.0, 1.5, 0.75, 4.0 / 3.0)


def comb_factors(x: torch.Tensor, pitch_hz: torch.Tensor, sample_rate: float = 16000,
                 n_fft: int = 2048, rel_threshold: float = 0.1, down_threshold: float = 0.25,
                 margin: float = 0.1, n_harmonics: int = 8,
                 ratios: Sequence[float] = _COMB_RATIOS, min_frequency_hz: float = 38.0,
                 frontend: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``comb_correct_pitch``'s clip factors [b] and the quantities its
    decisions compare: ``f0``, ``global_peak``, the normalised band peaks
    ``s`` [b, R, K] of each candidate ratio's comb (s[..., 0], the
    candidate's fundamental, against its admissibility threshold) and the
    comb ``score`` [b, R] (against the identity's times 1 + margin, and
    each other)."""
    spec = _clip_spectrum(x, n_fft, frontend)
    df = sample_rate / n_fft
    f0 = _median_frames(pitch_hz)
    nyquist = sample_rate / 2.0
    global_peak = spec.amax(dim=-1)
    r = device_constant(np.asarray(ratios, np.float32), spec.device)
    ks = torch.arange(1, n_harmonics + 1, dtype=torch.float32, device=spec.device)
    fc = f0[:, None] * r[None, :]  # [b, R]
    comb = fc[..., None] * ks  # [b, R, K]
    s = _band_peak(spec, comb, df) / (global_peak[:, None, None] + 1e-20)
    score = torch.sum(torch.where(comb < nyquist, torch.clamp(s, max=1.0), 0.0), dim=-1)
    thr = torch.where(r < 1.0, down_threshold, rel_threshold)[None, :]
    admissible = (s[..., 0] >= thr) & (fc >= min_frequency_hz) & (fc < nyquist)
    i1 = list(ratios).index(1.0)
    identity_valid = admissible[:, i1]
    identity_score = score[:, i1][:, None]
    # identity invalid -> any admissible candidate; identity valid -> only
    # down candidates that clearly beat it
    elig_invalid = admissible & (r != 1.0)[None, :]
    elig_valid = admissible & (r < 1.0)[None, :] & (score > identity_score * (1.0 + margin))
    eligible = torch.where(identity_valid[:, None], elig_valid, elig_invalid)
    best = torch.argmax(torch.where(eligible, score, float("-inf")), dim=-1)
    factor = torch.where(eligible.any(dim=-1), r[best], 1.0)
    return factor, {"f0": f0, "global_peak": global_peak, "s": s, "score": score}


def comb_correct_pitch(x: torch.Tensor, pitch_hz: torch.Tensor, **kwargs) -> torch.Tensor:
    """Unsupervised test-time harmonic-comb disambiguation
    (``sot_tpu/metrics.py:comb_correct_pitch``): each candidate ratio r of
    the clip's median pitch is scored by its comb's summed, peak-normalised
    band magnitudes; a candidate whose fundamental band is empty is
    inadmissible. Where the predicted fundamental is empty the best
    admissible other candidate wins; where it is occupied only a down
    candidate (r < 1) that beats its score by ``margin`` does. x [b, T],
    pitch_hz [b, frames, 1]; keyword arguments as ``comb_factors``."""
    factor, _ = comb_factors(x, pitch_hz, **kwargs)
    return pitch_hz * factor[:, None, None]


def wasserstein_distance(x: torch.Tensor, x_hat: torch.Tensor, p: float = 1,
                         n_fft: int = 512) -> torch.Tensor:
    """W_p^p between magnitude spectra on a fixed linspace support."""
    mag_x = stft_magnitude(x, size=n_fft, overlap=0.75)
    mag_x_hat = stft_magnitude(x_hat, size=n_fft, overlap=0.75)
    return Wasserstein1D(p=p, fixed_x=mag_x.shape[-1])(mag_x, mag_x_hat)


def compute_metrics(evaluation_metrics: Dict[str, bool], x: torch.Tensor, x_hat: torch.Tensor,
                    pitch_hz: torch.Tensor, true_pitch_hz: torch.Tensor,
                    frequency_unit: Optional[torch.Tensor] = None,
                    true_frequency_unit: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """The gated metric suite."""
    out: Dict[str, torch.Tensor] = {}
    if evaluation_metrics.get("mse", False):
        out["mse"] = mse(x, x_hat)
    if evaluation_metrics.get("log_spectral_distance", False):
        out["log_spectral_distance"] = log_spectral_distance(x, x_hat)
    if evaluation_metrics.get("mss", False):
        out["mss"] = ms_spectral_distance(x, x_hat, fft_sizes=[2048, 1024, 512, 256, 128, 64],
                                          mag_weight=1.0, logmag_weight=1.0, loss_type="L1")
    if evaluation_metrics.get("pitch_mse", False) and frequency_unit is not None:
        pitch_mse = mse(frequency_unit, true_frequency_unit, sort=True)
        out["pitch_mse"] = pitch_mse
        out["pitch_mse_db"] = 10.0 * safe_log10(pitch_mse)
    if evaluation_metrics.get("raw_pitch_accuracy", False):
        out["raw_pitch_accuracy"] = raw_pitch_accuracy(pitch_hz, true_pitch_hz)
    if evaluation_metrics.get("raw_chroma_accuracy", False):
        out["raw_chroma_accuracy"] = raw_chroma_accuracy(pitch_hz, true_pitch_hz)
    if evaluation_metrics.get("octave_difference", False):
        out["octave_difference"] = mean_octave_difference(pitch_hz, true_pitch_hz)
    if evaluation_metrics.get("1-wasserstein", False):
        out["1-wasserstein"] = wasserstein_distance(x, x_hat, p=1)
    if evaluation_metrics.get("2-wasserstein", False):
        out["2-wasserstein"] = wasserstein_distance(x, x_hat, p=2)
    return out
