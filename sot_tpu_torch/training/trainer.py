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
  * ``make_eval_step`` / ``make_eval_all`` / ``evaluate`` — the metric
    suite (``metrics.py``) and the loss terms of a batch in eval mode, their
    mean over batches, on the pitch as the config's eval corrections leave it
  * ``apply_octave_correction`` / ``apply_comb_correction`` — the
    unsupervised pitch corrections with the config's thresholds
  * ``predict`` — the deployment inference entry

Parameters live in ``mod.encoder``; the optimizer, scheduler, dropout
generator and step count in ``TrainState``. ``mod.kernels`` (a
``KernelGates``, ``kernel_gates.py``) holds the kernel gates that ``cli
train --kernels`` and the env gates set in the JAX package: the SOT loss's
route (``ops/wasserstein.w2_route``), the encoder's conv kernels and the
STFT frontend. ``train()`` with its
periodic evaluation, and checkpoints, come with a later slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sot_tpu_torch import data as data_lib
from sot_tpu_torch import losses as losses_lib
from sot_tpu_torch import metrics as metrics_lib
from sot_tpu_torch.configs import ExperimentConfig
from sot_tpu_torch.device import DeviceLike, resolve_device
from sot_tpu_torch.features import CQT, STFT, Identity
from sot_tpu_torch.kernel_gates import KernelGates, Kernels, resolve_gates
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
    kernels: KernelGates  # the kernel gates (resolved from a preset name)
    evaluation_metrics: Dict[str, bool]


def build_modules(cfg: ExperimentConfig, device: DeviceLike = None,
                  generator: Optional[torch.Generator] = None,
                  kernels: Kernels = "auto") -> Modules:
    """Build the model for ``cfg`` on ``device`` (default: the GPU; raises
    if there is none). ``generator`` seeds the encoder's initialisation;
    ``kernels`` (a ``KernelGates`` or a preset name) sets the kernel gates:
    the SOT loss's route (``w2_route``), the encoder's conv kernels, the
    STFT frontend of the loss transform and the MSS loss."""
    device = resolve_device(device)
    gates = resolve_gates(kernels)
    n_bins = get_cqt_n_bins(cfg.sample_rate, cfg.cqt_fmin, cfg.cqt_bins_per_semitone)
    feature_extractor = CQT(
        sample_rate=cfg.sample_rate, fmin=cfg.cqt_fmin,
        bins_per_semitone=cfg.cqt_bins_per_semitone, n_bins=n_bins,
        hop_length=cfg.cqt_hop_length)
    encoder = PESTOEncoder(
        n_bins_in=n_bins, output_size=n_bins, n_modes=cfg.n_modes,
        output_splits=("frequency", "weights"), harmonic=True,
        generator=generator, conv_dtype=gates.conv_dtype if gates.conv else None,
        conv_bf16=gates.conv_bf16,
    ).to(device).eval()
    decoder = Sinusoidal(
        n_samples=cfg.n_samples, sample_rate=cfg.sample_rate,
        amp_scale_fn=None, freq_scale_fn=None, harmonic=True,
        apply_roll_off=cfg.apply_roll_off)
    if cfg.transform == "identity":
        transform = Identity()
    else:
        transform = STFT(n_fft=cfg.transform_n_fft, hop_length=cfg.transform_hop,
                         sample_rate=cfg.sample_rate, window=cfg.transform_window,
                         kernels=gates)
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
                                    mag_weight=lc.mag_weight, logmag_weight=lc.logmag_weight,
                                    kernels=gates)
        elif lc.kind == "wasserstein":
            fn = losses_lib.Wasserstein1D(
                p=lc.p, square_dist=lc.square_dist, dont_normalize=lc.dont_normalize,
                limit_quantile_range=lc.limit_quantile_range,
                log_scaled_x=lc.log_scaled_x, target_constant=True, kernels=gates)
        else:
            raise ValueError(f"Unknown loss kind {lc.kind}")
        loss_fns.append((lc.kind, fn, lc.weight))

    return Modules(config=cfg, encoder=encoder, decoder=decoder,
                   feature_extractor=feature_extractor, transform=transform,
                   loss_fns=tuple(loss_fns), x_pos=x_pos,
                   freq_hz_min=freq_hz_min, freq_hz_max=freq_hz_max, device=device,
                   kernels=gates,
                   evaluation_metrics={name: True for name in cfg.evaluation_metrics})


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


def correction_kwargs(mod: Modules) -> Dict[str, Any]:
    """The pitch corrections' arguments from the config, as the JAX
    package's ``apply_*_correction`` pass them, and the STFT gate."""
    cfg = mod.config
    return {"sample_rate": cfg.sample_rate,
            "rel_threshold": cfg.octave_correction_rel_threshold,
            "down_threshold": cfg.octave_correction_down_threshold,
            "min_frequency_hz": 0.95 * cfg.freq_gen_min,
            "frontend": mod.kernels.stft_frontend}


def apply_octave_correction(mod: Modules, x: torch.Tensor, pitch_hz: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unsupervised octave correction with the config's thresholds (its
    STFT on kernel 9 under the ``stft_frontend`` gate); returns the
    corrected (pitch_hz, pitch_unit)."""
    pitch_hz = metrics_lib.octave_correct_pitch(x, pitch_hz, **correction_kwargs(mod))
    return pitch_hz, hz_to_unit(pitch_hz, mod.freq_hz_min, mod.freq_hz_max)


def apply_comb_correction(mod: Modules, x: torch.Tensor, pitch_hz: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The harmonic-comb correction (it supersedes the octave rule where
    both are enabled) with the config's thresholds and margin; returns the
    corrected (pitch_hz, pitch_unit)."""
    pitch_hz = metrics_lib.comb_correct_pitch(x, pitch_hz, margin=mod.config.comb_correction_margin,
                                              **correction_kwargs(mod))
    return pitch_hz, hz_to_unit(pitch_hz, mod.freq_hz_min, mod.freq_hz_max)


def _eval_metrics(mod: Modules, x: torch.Tensor, true_pitch: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """The metric suite and the loss terms of one batch, eval mode, the
    odd-ratio prior off (``prior_scale`` 0: eval losses stay comparable),
    the pitch corrected by the comb rule under ``eval_comb_correction``,
    else by the octave rule under ``eval_octave_correction``."""
    cfg = mod.config
    _, (logs, out) = compute_loss(mod, x, train=False, prior_scale=0.0)
    pitch_hz = out["pitch_hz"]  # [batch, frames, 1]
    pitch_unit = out["pitch_unit"]
    if cfg.eval_comb_correction:
        pitch_hz, pitch_unit = apply_comb_correction(mod, x, pitch_hz)
    elif cfg.eval_octave_correction:
        pitch_hz, pitch_unit = apply_octave_correction(mod, x, pitch_hz)
    true_hz = true_pitch[:, None, :].expand(pitch_hz.shape)
    true_unit = hz_to_unit(true_pitch, mod.freq_hz_min, mod.freq_hz_max)
    m = metrics_lib.compute_metrics(
        mod.evaluation_metrics, x, out["x_hat"], pitch_hz, true_hz,
        frequency_unit=pitch_unit,
        true_frequency_unit=true_unit[:, None, :].expand(pitch_hz.shape))
    m.update(logs)
    return m


def make_eval_step(mod: Modules) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """(x [batch, n_samples], true f0 [batch, 1]) -> {metric: 0-dim tensor}."""
    def eval_step(x: torch.Tensor, true_pitch: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return _eval_metrics(mod, x, true_pitch)

    return eval_step


def make_eval_all(mod: Modules) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """(xs [n_batches, batch, n_samples], f0s [n_batches, batch, 1]) -> the
    mean of each metric over the batches (equal batch weights)."""
    eval_step = make_eval_step(mod)

    def eval_all(xs: torch.Tensor, f0s: torch.Tensor) -> Dict[str, torch.Tensor]:
        ms = [eval_step(x, f0) for x, f0 in zip(xs, f0s)]
        return {k: torch.mean(torch.stack([m[k] for m in ms])) for k in ms[0]}

    return eval_all


def evaluate(mod: Modules, eval_step: Callable, split: data_lib.SplitArrays,
             batch_size: int) -> Dict[str, float]:
    """Mean of each metric over the split's batches (the last one may be
    short), each batch peak-normalised and sent to ``mod.device``."""
    sums: Dict[str, float] = {}
    count = 0
    for batch in data_lib.iterate_batches(split, batch_size, drop_last=False):
        m = eval_step(torch.as_tensor(batch["x"], dtype=torch.float32, device=mod.device),
                      torch.as_tensor(batch["frequency"], dtype=torch.float32,
                                      device=mod.device))
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
    return {k: v / max(count, 1) for k, v in sums.items()}


def predict(mod: Modules, x, octave_correction: Optional[bool] = None
            ) -> Dict[str, torch.Tensor]:
    """Deployment inference entry: pitch + harmonic amplitudes for audio x
    ([batch, n_samples], array or tensor), computed on ``mod.device``.

    Unlike the eval path, the unsupervised corrections rewrite the returned
    prediction: the comb rule under ``cfg.inference_comb_correction``, else
    the octave rule under ``octave_correction`` (default
    ``cfg.inference_octave_correction``).
    """
    if octave_correction is None:
        octave_correction = mod.config.inference_octave_correction
    x = torch.as_tensor(x, dtype=torch.float32, device=mod.device)
    with torch.inference_mode():
        out = forward(mod, x)
        if mod.config.inference_comb_correction:
            out["pitch_hz"], out["pitch_unit"] = apply_comb_correction(mod, x, out["pitch_hz"])
        elif octave_correction:
            out["pitch_hz"], out["pitch_unit"] = apply_octave_correction(mod, x, out["pitch_hz"])
        return out
