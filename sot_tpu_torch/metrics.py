"""Evaluation metrics (L4), port of ``sot_tpu/metrics.py``: LSD, MSE, MSS,
RPA, RCA, octave difference, W1/W2.

  * pitch accuracies with mir_eval.melody semantics (hz2cents from a 10 Hz
    base, 50-cent tolerance, octave folding for chroma), on the device
  * LSD = L2 of 10*log10(mag^2) at n_fft = 1024 (the checkpoint-selection
    metric)
  * MSS metric = six-scale magnitude + log-magnitude L1
  * signed mean octave difference with the 50-cent guard
  * W1/W2 spectral distance at n_fft = 512 on a fixed linspace support

The inference-time corrections (``octave_correct_pitch``,
``comb_correct_pitch``) are not ported yet (ROADMAP A).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

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
