"""Model assembly and the serving path (L5), port of ``sot_tpu/training/trainer.py``.

  * ``Modules`` — the bundle of encoder / decoder / feature extractor plus
    the pitch range derived from the CQT bins
  * ``forward`` — encode -> soft-argmax pitch -> unit_to_hz -> frozen synth
  * ``predict`` — the deployment inference entry

The loss functions, the train step and evaluation come with the training
slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from sot_tpu_torch.configs import ExperimentConfig
from sot_tpu_torch.device import DeviceLike, resolve_device
from sot_tpu_torch.features import CQT
from sot_tpu_torch.models.encoder import PESTOEncoder, predict_pitch
from sot_tpu_torch.models.synths import Sinusoidal
from sot_tpu_torch.ops.numerics import get_cqt_n_bins, unit_to_hz


@dataclasses.dataclass
class Modules:
    config: ExperimentConfig
    encoder: PESTOEncoder
    decoder: Sinusoidal
    feature_extractor: CQT
    freq_hz_min: float
    freq_hz_max: float
    device: torch.device


def build_modules(cfg: ExperimentConfig, device: DeviceLike = None,
                  generator: Optional[torch.Generator] = None) -> Modules:
    """Build the model for ``cfg`` on ``device`` (default: the GPU; raises
    if there is none). ``generator`` seeds the encoder's initialisation."""
    device = resolve_device(device)
    n_bins = get_cqt_n_bins(cfg.sample_rate, cfg.cqt_fmin, cfg.cqt_bins_per_semitone)
    feature_extractor = CQT(
        sample_rate=cfg.sample_rate, fmin=cfg.cqt_fmin,
        bins_per_semitone=cfg.cqt_bins_per_semitone, n_bins=n_bins,
        hop_length=cfg.cqt_hop_length)
    encoder = PESTOEncoder(
        n_bins_in=n_bins, output_size=n_bins, n_modes=cfg.n_modes,
        output_splits=("frequency", "weights"), harmonic=True,
        generator=generator).to(device).eval()
    decoder = Sinusoidal(
        n_samples=cfg.n_samples, sample_rate=cfg.sample_rate,
        amp_scale_fn=None, freq_scale_fn=None, harmonic=True,
        apply_roll_off=cfg.apply_roll_off)
    feats = feature_extractor.get_frequencies()
    return Modules(config=cfg, encoder=encoder, decoder=decoder,
                   feature_extractor=feature_extractor,
                   freq_hz_min=float(feats[0]), freq_hz_max=float(feats[-1]),
                   device=device)


def forward(mod: Modules, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Autoencoder forward. x: [batch, n_samples] on ``mod.device``.

    Returns x_hat, pitch_unit, pitch_hz, weights and frequency logits. The
    encoder's train/eval mode (dropout) is the module's own. The training
    slice adds the annealed temperature and the detached-weights ablation.
    """
    features = mod.feature_extractor(x[:, :-1])  # drop the last sample (ref parity)
    batch, n_frames, n_bins = features.shape
    z = mod.encoder(features.reshape(batch * n_frames, n_bins))

    pitch_unit = predict_pitch(
        z["frequency"], estimation_type=mod.config.estimation_type,
        temperature=mod.config.temperature)["pitch_unit"]  # [batch*frames, 1]
    pitch_hz = unit_to_hz(pitch_unit, mod.freq_hz_min, mod.freq_hz_max)

    pitch_unit = pitch_unit.reshape(batch, n_frames, -1)
    pitch_hz = pitch_hz.reshape(batch, n_frames, -1)
    weights = z["weights"].reshape(batch, n_frames, -1)

    return {
        "x_hat": mod.decoder(weights, pitch_hz),
        "pitch_unit": pitch_unit,
        "pitch_hz": pitch_hz,
        "weights": weights,
        "frequency_logits": z["frequency"].reshape(batch, n_frames, -1),
    }


def predict(mod: Modules, x, octave_correction: Optional[bool] = None
            ) -> Dict[str, torch.Tensor]:
    """Deployment inference entry: pitch + harmonic amplitudes for audio x
    ([batch, n_samples], array or tensor), computed on ``mod.device``.

    The inference-time octave and comb corrections need ``metrics.py``,
    which is not ported yet: asking for either raises.
    """
    if octave_correction is None:
        octave_correction = mod.config.inference_octave_correction
    if mod.config.inference_comb_correction or octave_correction:
        raise NotImplementedError(
            "inference_comb_correction / inference_octave_correction need "
            "metrics.py, which is not ported yet (ROADMAP)")
    x = torch.as_tensor(x, dtype=torch.float32, device=mod.device)
    mod.encoder.eval()
    with torch.inference_mode():
        return forward(mod, x)
