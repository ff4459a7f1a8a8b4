"""Model assembly, losses, the train step and the serving path (L5), port of
``sot_tpu/training/trainer.py``.

  * ``Modules`` — encoder / decoder / feature extractor, the loss-domain
    transform, the loss functions and their positions, the pitch range
    derived from the CQT bins
  * ``forward`` — encode -> soft-argmax pitch -> unit_to_hz -> frozen synth
  * ``compute_loss`` — MSS on raw audio, Wasserstein-1D on the transformed
    spectra, the optional odd-ratio prior
  * ``make_optimizer`` / ``init_state`` / ``train_step`` / ``train_steps`` —
    Adam with coupled L2 (torch.optim.Adam's ``weight_decay``, what the JAX
    package builds from ``optax.add_decayed_weights`` + ``scale_by_adam``),
    the warmup/cosine schedule as a ``LambdaLR``, and loops over a
    device-resident dataset
  * ``predict`` — the deployment inference entry

Parameters live in ``mod.encoder``; the optimizer, scheduler, dropout
generator and step count in ``TrainState``. ``train()`` with its periodic
evaluation and checkpoints comes with the evaluation slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sot_tpu_torch import losses as losses_lib
from sot_tpu_torch.configs import ExperimentConfig
from sot_tpu_torch.device import DeviceLike, resolve_device
from sot_tpu_torch.features import CQT, STFT, Identity
from sot_tpu_torch.models.encoder import PESTOEncoder, predict_pitch
from sot_tpu_torch.models.synths import Sinusoidal
from sot_tpu_torch.ops.numerics import get_cqt_n_bins, hz_to_unit, unit_to_hz


@dataclasses.dataclass
class Modules:
    config: ExperimentConfig
    encoder: PESTOEncoder
    decoder: Sinusoidal
    feature_extractor: CQT
    transform: Union[STFT, Identity]
    loss_fns: Tuple[Tuple[str, Any, float], ...]  # (kind, fn, weight)
    x_pos: Optional[np.ndarray]  # loss-domain positions in [0, 1]
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
    if cfg.transform == "identity":
        transform = Identity()
    else:
        transform = STFT(n_fft=cfg.transform_n_fft, hop_length=cfg.transform_hop,
                         sample_rate=cfg.sample_rate, window=cfg.transform_window)
    feats = feature_extractor.get_frequencies()
    freq_hz_min, freq_hz_max = float(feats[0]), float(feats[-1])

    # loss-domain positions: a numpy constant, so the loss can check on the
    # host that the grid is sorted (the same-grid fast path)
    x_pos: Optional[np.ndarray] = None
    if not isinstance(transform, Identity):
        freqs = transform.get_frequencies()
        if any(lc.log_scaled_x for lc in cfg.losses):
            x_pos = hz_to_unit(freqs, freq_hz_min, freq_hz_max).numpy()
        else:
            x_pos = (freqs / freqs.max()).astype(np.float32)

    loss_fns = []
    for lc in cfg.losses:
        if lc.kind == "mss":
            fn = losses_lib.MSSLoss(fft_sizes=lc.fft_sizes, loss_type=lc.loss_type,
                                    mag_weight=lc.mag_weight, logmag_weight=lc.logmag_weight)
        elif lc.kind == "wasserstein":
            fn = losses_lib.Wasserstein1D(
                p=lc.p, square_dist=lc.square_dist, dont_normalize=lc.dont_normalize,
                limit_quantile_range=lc.limit_quantile_range,
                log_scaled_x=lc.log_scaled_x, target_constant=True)
        else:
            raise ValueError(f"Unknown loss kind {lc.kind}")
        loss_fns.append((lc.kind, fn, lc.weight))

    return Modules(config=cfg, encoder=encoder, decoder=decoder,
                   feature_extractor=feature_extractor, transform=transform,
                   loss_fns=tuple(loss_fns), x_pos=x_pos,
                   freq_hz_min=freq_hz_min, freq_hz_max=freq_hz_max, device=device)


def temperature_at(cfg: ExperimentConfig, step: int) -> float:
    """Soft-argmax temperature at a training step: with
    ``cfg.temperature_schedule = (T0, T1, n)`` a log-space cosine anneal
    T0 -> T1 over the first n steps, then T1; else ``cfg.temperature``."""
    if cfg.temperature_schedule is None:
        return cfg.temperature
    t0, t1, n = cfg.temperature_schedule
    frac = min(max(step / float(n), 0.0), 1.0)
    log_t = math.log(t1) + 0.5 * (math.log(t0) - math.log(t1)) * (1.0 + math.cos(math.pi * frac))
    return math.exp(log_t)


def prior_scale_at(cfg: ExperimentConfig, step: int) -> Optional[float]:
    """0/1 gate of the odd-ratio prior (on from ``odd_ratio_prior_start``),
    or None when the prior is off or ungated."""
    if cfg.odd_ratio_prior_weight <= 0.0 or cfg.odd_ratio_prior_start <= 0:
        return None
    return float(step >= cfg.odd_ratio_prior_start)


def forward(mod: Modules, x: torch.Tensor, train: bool = False,
            temperature: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """Autoencoder forward. x: [batch, n_samples] on ``mod.device``.

    ``train`` puts the encoder in training mode (dropout, masks from
    ``mod.encoder.dropout.generator``); ``temperature`` overrides the
    config's soft-argmax temperature (the training anneal). Returns x_hat,
    pitch_unit, pitch_hz, weights and frequency logits, plus
    ``x_hat_weights_detached`` under ``cfg.detach_weights``.
    """
    mod.encoder.train(train)
    features = mod.feature_extractor(x[:, :-1])  # drop the last sample (ref parity)
    batch, n_frames, n_bins = features.shape
    z = mod.encoder(features.reshape(batch * n_frames, n_bins))

    pitch_unit = predict_pitch(
        z["frequency"], estimation_type=mod.config.estimation_type,
        temperature=mod.config.temperature if temperature is None else temperature,
    )["pitch_unit"]  # [batch*frames, 1]
    pitch_hz = unit_to_hz(pitch_unit, mod.freq_hz_min, mod.freq_hz_max)

    pitch_unit = pitch_unit.reshape(batch, n_frames, -1)
    pitch_hz = pitch_hz.reshape(batch, n_frames, -1)
    weights = z["weights"].reshape(batch, n_frames, -1)

    out = {
        "x_hat": mod.decoder(weights, pitch_hz),
        "pitch_unit": pitch_unit,
        "pitch_hz": pitch_hz,
        "weights": weights,
        "frequency_logits": z["frequency"].reshape(batch, n_frames, -1),
    }
    if mod.config.detach_weights:
        # ablation: a second render with the amplitude head detached, fed
        # only to the Wasserstein term (MSS still trains the weights)
        out["x_hat_weights_detached"] = mod.decoder(weights.detach(), pitch_hz)
    return out


def compute_loss(mod: Modules, x: torch.Tensor, train: bool = False,
                 temperature: Optional[float] = None,
                 prior_scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
    """(total, (logs, outputs)): MSS on raw audio, Wasserstein-1D on the
    transformed spectra, each times its weight, plus the odd-ratio prior."""
    out = forward(mod, x, train=train, temperature=temperature)
    x_hat = out["x_hat"]
    spec_x = mod.transform(x)
    spec_x_hat = mod.transform(x_hat)
    spec_x_hat_w = (mod.transform(out["x_hat_weights_detached"])
                    if mod.config.detach_weights else spec_x_hat)
    pos = mod.x_pos

    total = 0.0
    logs: Dict[str, torch.Tensor] = {}
    for kind, fn, weight in mod.loss_fns:
        if kind == "mss":
            value = fn(x, x_hat) * weight
        else:
            value = fn(spec_x, spec_x_hat_w, x_pos=pos, y_pos=pos) * weight
        logs[f"loss/{type(fn).__name__}"] = value
        total = total + value
    cfg = mod.config
    if cfg.odd_ratio_prior_weight > 0.0:
        # octave-degeneracy breaker: penalise vanishing odd-mode energy
        # among the modes the synth does not Nyquist-mask
        w = out["weights"]  # [batch, frames, n_modes]
        k = torch.arange(1, w.shape[-1] + 1, dtype=torch.float32, device=w.device)
        audible = (k[None, None, :] * out["pitch_hz"] < cfg.sample_rate / 2.0).to(w.dtype)
        w = w * audible
        ratio = w[..., 0::2].sum(dim=-1) / (w.sum(dim=-1) + 1e-7)
        prior = -torch.log(ratio + 1e-6).mean() * cfg.odd_ratio_prior_weight
        if prior_scale is not None:
            prior = prior * prior_scale
        logs["loss/OddRatioPrior"] = prior
        total = total + prior
    logs["loss/total"] = total
    out.update({"spec_x": spec_x, "spec_x_hat": spec_x_hat})
    return total, (logs, out)


def lr_multiplier(cfg: ExperimentConfig, step: int) -> float:
    """The learning rate at an update, as a fraction of ``cfg.learning_rate``:
    linear warmup 0 -> 1 over ``lr_warmup_steps``, then constant or a cosine
    decay to 0 at ``max_steps`` (optax's linear / cosine_decay schedules
    joined at the warmup boundary)."""
    if cfg.lr_decay not in ("constant", "cosine"):
        raise ValueError(f"Unknown lr_decay {cfg.lr_decay!r}")
    warmup = cfg.lr_warmup_steps
    if step < warmup:
        return step / warmup
    if cfg.lr_decay == "constant":
        return 1.0
    decay_steps = max(cfg.max_steps - warmup, 1)
    s = min(step - warmup, decay_steps)
    return 0.5 * (1.0 + math.cos(math.pi * s / decay_steps))


def make_optimizer(cfg: ExperimentConfig, params
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam with coupled L2 (the decay is added to the gradient before the
    moments, not decoupled as in AdamW) and the lr schedule; update k
    (from 0) runs at ``learning_rate * lr_multiplier(cfg, k)``."""
    opt = torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: lr_multiplier(cfg, s))
    return opt, sched


@dataclasses.dataclass
class TrainState:
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    generator: torch.Generator  # dropout masks, on the model's device
    step: int = 0


def init_state(mod: Modules, seed: Optional[int] = None) -> TrainState:
    """Optimizer, schedule and a dropout generator on ``mod.device`` seeded
    from ``seed`` (default ``cfg.seed``); the encoder's dropout draws from it."""
    gen = torch.Generator(device=mod.device)
    gen.manual_seed(mod.config.seed if seed is None else seed)
    mod.encoder.dropout.generator = gen
    opt, sched = make_optimizer(mod.config, mod.encoder.parameters())
    return TrainState(optimizer=opt, scheduler=sched, generator=gen)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def train_step(mod: Modules, state: TrainState, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One update on batch x [batch, n_samples]: loss in training mode,
    ``backward``, Adam. Returns the logs (device tensors, not synchronised)
    with ``grad_norm``, the global norm of the raw gradients."""
    cfg = mod.config
    state.optimizer.zero_grad(set_to_none=True)
    loss, (logs, _) = compute_loss(mod, x, train=True,
                                   temperature=temperature_at(cfg, state.step),
                                   prior_scale=prior_scale_at(cfg, state.step))
    loss.backward()
    params = [p for p in mod.encoder.parameters() if p.grad is not None]
    logs = {k: v.detach() for k, v in logs.items()}
    logs["grad_norm"] = global_norm([p.grad for p in params]).detach()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return logs


def train_steps(mod: Modules, state: TrainState, x_all: torch.Tensor,
                offsets: Sequence[int]) -> Dict[str, torch.Tensor]:
    """One ``train_step`` per batch offset into the device-resident dataset
    ``x_all`` [n, n_samples] (batch = ``cfg.batch_size``); the last step's logs."""
    bs = mod.config.batch_size
    logs: Dict[str, torch.Tensor] = {}
    for lo in offsets:
        lo = int(lo)
        logs = train_step(mod, state, x_all[lo:lo + bs])
    return logs


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
    with torch.inference_mode():
        return forward(mod, x)
