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
    package builds from ``optax.add_decayed_weights`` + ``scale_by_adam``;
    capturable on the GPU), the warmup/cosine schedule as a ``LambdaLR``,
    and the eager loop over a device-resident dataset
  * ``temperature_tensor`` / ``prior_scale_tensor`` / ``lr_tensor`` /
    ``train_step_indexed`` / ``TrainGraph`` / ``train_steps_graph`` — the
    schedules from a device step tensor, the step that reads its batch by
    a device offset, and that step captured into a CUDA graph and replayed
    once per batch (the JAX package's scanned epoch, ``make_train_steps_scan``)
  * ``make_eval_step`` / ``EvalGraph`` / ``make_eval_all`` / ``evaluate`` —
    the metric suite (``metrics.py``) and the loss terms of a batch in eval
    mode, their mean over batches (on the GPU one graph replayed per batch,
    the JAX package's scanned evaluation), on the pitch as the config's eval
    corrections leave it
  * ``make_viz_step`` — the arrays of the figure gallery for one batch
    (``training/observability.py``), eager under ``inference_mode``
  * ``apply_octave_correction`` / ``apply_comb_correction`` — the
    unsupervised pitch corrections with the config's thresholds
  * ``predict`` / ``PredictGraph`` — the deployment inference entry: on
    the GPU one CUDA graph per input shape and correction flag (the JAX
    package's jitted ``predict``), on the CPU the same body eagerly
  * ``train`` — the training run: epochs of shuffled batches from the
    device-resident train split, periodic evaluation on the val split,
    the init-probe restarts, the best-LSD snapshot, checkpoints
    (``checkpoint.py``), JSONL records (``logging.py``) and the figure
    gallery of each evaluation (``observability.py``)

Parameters live in ``mod.encoder``; the optimizer, scheduler, dropout
generator and step count in ``TrainState``. ``mod.kernels`` (a
``KernelGates``, ``kernel_gates.py``) holds the kernel gates that ``cli
train --kernels`` and the env gates set in the JAX package: the SOT loss's
route (``ops/wasserstein.w2_route``), the encoder's conv kernels and the
STFT frontend.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sot_tpu_torch import data as data_lib
from sot_tpu_torch import losses as losses_lib
from sot_tpu_torch import metrics as metrics_lib
from sot_tpu_torch.configs import ExperimentConfig
from sot_tpu_torch.device import DeviceLike, device_constant, resolve_device
from sot_tpu_torch.features import CQT, STFT, Identity
from sot_tpu_torch.kernel_gates import KernelGates, Kernels, resolve_gates
from sot_tpu_torch.models.encoder import PESTOEncoder, predict_pitch
from sot_tpu_torch.models.synths import Sinusoidal
from sot_tpu_torch.ops.kernels import launches as launches_lib
from sot_tpu_torch.ops.numerics import get_cqt_n_bins, hz_to_unit, unit_to_hz
from sot_tpu_torch.training import checkpoint as ckpt_lib
from sot_tpu_torch.training.logging import JsonlLogger
from sot_tpu_torch.training.observability import FigureLogger


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
    # ``predict``'s CUDA graphs, by (input shape, octave_correction); freed
    # with these Modules (a copy made by ``dataclasses.replace`` starts empty)
    serve_graphs: Dict[Tuple[Tuple[int, ...], bool], "PredictGraph"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)


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


# The schedules' tensor forms: the step is an integer tensor on the device
# (the CUDA graph's step counter), and each value is computed in float32 with
# the JAX package's operations in its order, as it computes them from its
# traced step. ``temperature_at``, ``prior_scale_at`` and ``lr_multiplier``
# stay the eager path's host forms.


def temperature_tensor(cfg: ExperimentConfig, step: torch.Tensor) -> Union[float, torch.Tensor]:
    """``temperature_at`` from a step tensor (``sot_tpu/training/trainer.py:
    temperature_at``); without a schedule the config's float, as there."""
    if cfg.temperature_schedule is None:
        return cfg.temperature
    t0, t1, n = cfg.temperature_schedule
    log_t1 = np.log(np.float32(t1))
    half = np.float32(0.5) * (np.log(np.float32(t0)) - log_t1)
    frac = torch.clamp(step.to(torch.float32) / float(n), 0.0, 1.0)
    return torch.exp(float(log_t1) + float(half) * (1.0 + torch.cos(math.pi * frac)))


def prior_scale_tensor(cfg: ExperimentConfig, step: torch.Tensor) -> Optional[torch.Tensor]:
    """``prior_scale_at`` from a step tensor: float32 0/1, or None."""
    if cfg.odd_ratio_prior_weight <= 0.0 or cfg.odd_ratio_prior_start <= 0:
        return None
    return (step >= cfg.odd_ratio_prior_start).to(torch.float32)


def lr_tensor(cfg: ExperimentConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate of update ``step`` (a step tensor) as float32, as
    the optax schedule of the JAX package's ``make_optimizer`` computes it:
    ``linear_schedule(0, lr, warmup)`` joined at the warmup boundary to
    ``constant_schedule(lr)`` or ``cosine_decay_schedule(lr, max_steps -
    warmup)``; the constant lr without either."""
    if cfg.lr_decay not in ("constant", "cosine"):
        raise ValueError(f"Unknown lr_decay {cfg.lr_decay!r}")
    lr, warmup = cfg.learning_rate, cfg.lr_warmup_steps
    const = torch.full((), lr, dtype=torch.float32, device=step.device)
    if cfg.lr_decay == "constant":
        after = const
    else:
        decay_steps = float(max(cfg.max_steps - warmup, 1))
        count = torch.clamp((step - warmup).to(torch.float32), max=decay_steps)
        after = lr * (0.5 * (1.0 + torch.cos(math.pi * count / decay_steps)))
    if warmup == 0:
        return after
    frac = 1.0 - torch.clamp(step, 0, warmup).to(torch.float32) / float(warmup)
    return torch.where(step < warmup, (0.0 - lr) * frac + lr, after)


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
    (from 0) runs at ``learning_rate * lr_multiplier(cfg, k)``.

    On the GPU the Adam is ``capturable`` (its step counts live on the
    device, so a CUDA graph can replay the update; ``TrainGraph`` hands it
    its lr as a device tensor); the CPU keeps the plain Adam, which is all
    the CPU accepts. The two order the bias correction differently, a
    rounding-level difference (PERF.md §6)."""
    params = list(params)
    capturable = bool(params) and params[0].device.type == "cuda"
    opt = torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=cfg.weight_decay, capturable=capturable)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: lr_multiplier(cfg, s))
    return opt, sched


@dataclasses.dataclass
class TrainState:
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    generator: torch.Generator  # dropout masks, on the model's device
    step: int = 0
    # the CUDA graph of this state's train step (``train_steps_graph``),
    # captured at its first chunk; a checkpoint restore drops it
    graph: Optional["TrainGraph"] = dataclasses.field(default=None, repr=False)


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


def train_step(mod: Modules, state: TrainState, x: torch.Tensor,
               reduce_grads: Optional[Callable[[Sequence[torch.Tensor]], None]] = None
               ) -> Dict[str, torch.Tensor]:
    """One update on batch x [batch, n_samples]: loss in training mode,
    ``backward``, Adam. Returns the logs (device tensors, not synchronised)
    with ``grad_norm``, the global norm of the raw gradients.
    ``reduce_grads`` (the multi-rank step's all-reduce) rewrites the
    gradients in place before the norm and the update."""
    cfg = mod.config
    state.optimizer.zero_grad(set_to_none=True)
    loss, (logs, _) = compute_loss(mod, x, train=True,
                                   temperature=temperature_at(cfg, state.step),
                                   prior_scale=prior_scale_at(cfg, state.step))
    loss.backward()
    params = [p for p in mod.encoder.parameters() if p.grad is not None]
    if reduce_grads is not None:
        reduce_grads([p.grad for p in params])
    logs = {k: v.detach() for k, v in logs.items()}
    logs["grad_norm"] = global_norm([p.grad for p in params]).detach()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return logs


def train_steps(mod: Modules, state: TrainState, x_all: torch.Tensor,
                offsets: Sequence[int]) -> Dict[str, torch.Tensor]:
    """One ``train_step`` per batch offset into the device-resident dataset
    ``x_all`` [n, n_samples] (batch = ``cfg.batch_size``); the last step's
    logs. The eager loop, the JAX package's per-step ``make_train_step``:
    ``train()`` runs it on the CPU, ``train_steps_graph`` on the GPU."""
    bs = mod.config.batch_size
    logs: Dict[str, torch.Tensor] = {}
    for lo in offsets:
        lo = int(lo)
        logs = train_step(mod, state, x_all[lo:lo + bs])
    return logs


def train_step_indexed(mod: Modules, state: TrainState, x_all: torch.Tensor,
                       offsets: torch.Tensor, index: torch.Tensor, step: torch.Tensor,
                       lr: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``train_step`` with everything that changes from step to step read
    from tensors on the dataset's device, the body ``TrainGraph`` captures
    (the JAX package's ``make_train_step_from_dataset``): the batch is the
    ``batch_size`` rows of ``x_all`` from ``offsets[index]``, the
    temperature, prior gate and lr are the tensor forms at ``step``; ``step``
    and ``index`` advance by one in place. ``lr`` receives the step's
    learning rate: capturable Adam reads it as a tensor, the CPU's Adam as a
    float (the schedule's own stays in the optimizer outside this call)."""
    cfg = mod.config
    rows = (offsets.index_select(0, index.view(1))
            + device_constant(np.arange(cfg.batch_size), x_all.device))
    x = x_all.index_select(0, rows)
    state.optimizer.zero_grad(set_to_none=True)
    loss, (logs, _) = compute_loss(mod, x, train=True, temperature=temperature_tensor(cfg, step),
                                   prior_scale=prior_scale_tensor(cfg, step))
    loss.backward()
    params = [p for p in mod.encoder.parameters() if p.grad is not None]
    logs = {k: v.detach() for k, v in logs.items()}
    logs["grad_norm"] = global_norm([p.grad for p in params]).detach()
    lr.copy_(lr_tensor(cfg, step))
    groups = state.optimizer.param_groups
    scheduled = [g["lr"] for g in groups]
    for g in groups:
        g["lr"] = lr if lr.device.type == "cuda" else float(lr)
    try:
        state.optimizer.step()
    finally:
        for g, value in zip(groups, scheduled):
            g["lr"] = value
    step += 1
    index += 1
    return logs


# eager runs of a step on a side stream before its capture: they build the
# kernels, fill the host caches, make Adam's state and pick cuDNN's algorithms
GRAPH_WARMUP = 3


def _snapshot(mod: Modules, state: TrainState) -> Dict[str, Any]:
    """Copies of what a train step changes: parameters, Adam's state, the
    dropout generator."""
    return {"params": {k: v.detach().clone() for k, v in mod.encoder.state_dict().items()},
            "adam": {p: {k: v.clone() for k, v in s.items() if isinstance(v, torch.Tensor)}
                     for p, s in state.optimizer.state.items()},
            "generator": state.generator.get_state()}


def _restore(mod: Modules, state: TrainState, snap: Dict[str, Any]) -> None:
    """Put a ``_snapshot`` back in place (the tensors keep their addresses);
    Adam state made since (the first update's lazy init) goes back to its
    initial zeros."""
    with torch.no_grad():
        for k, v in mod.encoder.state_dict().items():
            v.copy_(snap["params"][k])
        for p, s in state.optimizer.state.items():
            saved = snap["adam"].get(p)
            for k, v in s.items():
                if isinstance(v, torch.Tensor):
                    v.zero_() if saved is None else v.copy_(saved[k])
    state.generator.set_state(snap["generator"])


class TrainGraph:
    """One train step (``train_step_indexed``) captured into a CUDA graph for
    ``state`` on the dataset ``x_all``, the counterpart of the JAX package's
    ``make_train_steps_scan`` (an epoch as one XLA program).

    Built by warming the step up on a side stream (``GRAPH_WARMUP``
    updates), putting parameters, Adam's state and the generator back as
    they were, then capturing one step. The dropout generator is registered
    with the graph, so replayed masks continue its eager stream. The
    gradients are allocated by the captured backward, in the graph's memory
    pool. A call runs a chunk: the chunk's offsets go to the device once (an
    epoch's at most: a longer chunk goes in pieces), the device step is set
    from ``state.step``, the graph is replayed once per offset, then
    ``state.step`` and the host schedule advance as many updates. It returns
    the last step's logs, the graph's own output tensors (overwritten by the
    next replay). Each kernel wrapper's launch count advances by its
    launches in the capture times the replays (``ops/kernels/launches.py``).
    A capture that fails raises.
    """

    def __init__(self, mod: Modules, state: TrainState, x_all: torch.Tensor):
        if mod.device.type != "cuda" or x_all.device.type != "cuda":
            raise ValueError(f"TrainGraph: a CUDA graph needs the model and the dataset on "
                             f"the GPU (model on {mod.device}, dataset on {x_all.device})")
        dev = x_all.device
        self.mod, self.state, self.x_all = mod, state, x_all
        self.capacity = x_all.shape[0] // mod.config.batch_size
        if self.capacity == 0:
            raise ValueError(f"TrainGraph: {x_all.shape[0]} samples < batch_size")
        self.offsets = torch.zeros(self.capacity, dtype=torch.int64, device=dev)
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)

        snap = _snapshot(mod, state)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                self._prime()
                self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        _restore(mod, state, snap)

        before = launches_lib.read()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.generator)
        with torch.cuda.graph(self.graph):
            self.logs = self._body()
        self.launches = launches_lib.delta(before, launches_lib.read())
        launches_lib.write(before)
        state.generator.set_state(snap["generator"])

    def _prime(self) -> None:
        self.index.zero_()
        self.step.fill_(self.state.step)

    def _body(self) -> Dict[str, torch.Tensor]:
        return train_step_indexed(self.mod, self.state, self.x_all, self.offsets, self.index,
                                  self.step, self.lr)

    def __call__(self, offsets: Sequence[int]) -> Dict[str, torch.Tensor]:
        offsets = np.asarray(offsets, np.int64)
        bs = self.mod.config.batch_size
        if len(offsets) == 0 or offsets.min() < 0 or offsets.max() + bs > self.x_all.shape[0]:
            raise ValueError(f"TrainGraph: {len(offsets)} offsets, each in "
                             f"[0, {self.x_all.shape[0] - bs}]")
        # an epoch's offsets fit the buffer; a longer chunk goes in pieces
        for lo in range(0, len(offsets), self.capacity):
            piece = offsets[lo:lo + self.capacity]
            k = len(piece)
            self.offsets[:k].copy_(torch.from_numpy(piece))
            self._prime()
            for _ in range(k):
                self.graph.replay()
            launches_lib.add(self.launches, k)
            self.state.step += k
            for _ in range(k):
                self.state.scheduler.step()
        return self.logs


def train_steps_graph(mod: Modules, state: TrainState, x_all: torch.Tensor,
                      offsets: Sequence[int]) -> Dict[str, torch.Tensor]:
    """``train_steps`` as graph replays: ``state.graph`` (captured at the
    first call, again for another model or dataset) replayed once per
    offset; the last step's logs."""
    graph = state.graph
    if graph is None or graph.mod is not mod or graph.x_all is not x_all:
        graph = state.graph = TrainGraph(mod, state, x_all)
    return graph(offsets)


def make_viz_step(mod: Modules) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """x [batch, n_samples] -> the arrays the figure gallery draws: x,
    x_hat, spec_x, spec_x_hat, pitch_hz and the pitch probabilities of each
    clip's first frame (softmax of the frequency logits over the config's
    temperature). ``compute_loss`` in eval mode, run eagerly under
    ``inference_mode`` (on the GPU too: a figure is host work once per
    evaluation, outside the step's graph)."""
    def viz_step(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            _, (_, out) = compute_loss(mod, x, train=False)
            probs = torch.softmax(out["frequency_logits"] / mod.config.temperature, dim=-1)
            return {"x": x, "x_hat": out["x_hat"], "spec_x": out["spec_x"],
                    "spec_x_hat": out["spec_x_hat"], "probabilities": probs[:, 0],
                    "pitch_hz": out["pitch_hz"]}

    return viz_step


def log_figures(mod: Modules, fig_logger: Any, viz_step: Callable, step: int,
                batch: Dict[str, np.ndarray]) -> None:
    """The gallery of one evaluation from ``batch`` (the val split's first):
    ``viz_step``'s arrays copied to the host once, ``plot_and_log``, and the
    quantile-function figure of the first clip's spectra from the config's
    ``Wasserstein1D`` (``return_quantiles``: the general sorting path, never
    the training route)."""
    outs = {k: v.cpu().numpy() for k, v in viz_step(torch.as_tensor(
        np.asarray(batch["x"], np.float32), device=mod.device)).items()}
    outs["true_frequency_unit"] = hz_to_unit(batch["frequency"][:1, 0], mod.freq_hz_min,
                                             mod.freq_hz_max).numpy()
    trans_freqs = (None if isinstance(mod.transform, Identity)
                   else mod.transform.get_frequencies())
    fig_logger.plot_and_log(step, "val", outs, transform_frequencies=trans_freqs,
                            feature_frequencies=mod.feature_extractor.get_frequencies())
    w1d = next((fn for _, fn, _ in mod.loss_fns if type(fn).__name__ == "Wasserstein1D"), None)
    if w1d is not None and mod.x_pos is not None:
        with torch.inference_mode():
            q = w1d(torch.from_numpy(outs["spec_x"][:1]).to(mod.device),
                    torch.from_numpy(outs["spec_x_hat"][:1]).to(mod.device),
                    x_pos=mod.x_pos, y_pos=mod.x_pos, return_quantiles=True)
        fig_logger.log_quantiles(step, "val", *(q[i].cpu().numpy() for i in (2, 0, 1)))


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


class EvalGraph:
    """``_eval_metrics`` of one full batch captured into a CUDA graph under
    ``no_grad`` and replayed over the stacked batches ``xs``, ``f0s`` (the
    JAX package's scanned ``make_eval_all``): a device counter picks each
    replay's batch and the row its metrics are written to; a call returns
    each metric's mean over the batches, taken on the device as the eager
    ``make_eval_all`` takes it. Warmed up on a side stream first (eval
    changes no state); launch counts advance per replay as in ``TrainGraph``.
    """

    def __init__(self, mod: Modules, xs: torch.Tensor, f0s: torch.Tensor):
        if xs.device.type != "cuda" or f0s.device != xs.device:
            raise ValueError(f"EvalGraph: the batches must be on the GPU ({xs.device})")
        self.mod, self.xs, self.f0s = mod, xs, f0s
        self.index = torch.zeros((), dtype=torch.int64, device=xs.device)
        side = torch.cuda.Stream(xs.device)
        side.wait_stream(torch.cuda.current_stream(xs.device))
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(GRAPH_WARMUP):
                self.keys = list(_eval_metrics(mod, xs[0], f0s[0]))
        torch.cuda.current_stream(xs.device).wait_stream(side)
        self.rows = torch.zeros((xs.shape[0], len(self.keys)), dtype=torch.float32,
                                device=xs.device)
        before = launches_lib.read()
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph):
            pick = self.index.view(1)
            m = _eval_metrics(mod, xs.index_select(0, pick)[0], f0s.index_select(0, pick)[0])
            self.rows.index_copy_(0, pick, torch.stack([m[k] for k in self.keys])[None])
            self.index += 1
        self.launches = launches_lib.delta(before, launches_lib.read())
        launches_lib.write(before)

    def __call__(self) -> Dict[str, torch.Tensor]:
        n = self.xs.shape[0]
        self.index.zero_()
        for _ in range(n):
            self.graph.replay()
        launches_lib.add(self.launches, n)
        return {k: torch.mean(self.rows[:, j].contiguous()) for j, k in enumerate(self.keys)}


def make_eval_all(mod: Modules
                  ) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """(xs [n_batches, batch, n_samples], f0s [n_batches, batch, 1]) -> the
    mean of each metric over the batches (equal batch weights). On the GPU
    one ``EvalGraph``, captured at the first call and again for other
    batches; on the CPU an eager loop of the eval step."""
    eval_step = make_eval_step(mod)
    captured: Dict[str, EvalGraph] = {}

    def eval_all(xs: torch.Tensor, f0s: torch.Tensor) -> Dict[str, torch.Tensor]:
        if mod.device.type == "cuda":
            g = captured.get("graph")
            if g is None or g.xs is not xs or g.f0s is not f0s:
                g = captured["graph"] = EvalGraph(mod, xs, f0s)
            return g()
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


def _predict_body(mod: Modules, x: torch.Tensor, octave_correction: bool
                  ) -> Dict[str, torch.Tensor]:
    """The serving math, the body ``PredictGraph`` captures and the CPU runs:
    ``forward`` in eval mode, then the comb correction under
    ``cfg.inference_comb_correction``, else the octave correction under
    ``octave_correction``. x: [batch, n_samples] on ``mod.device``."""
    out = forward(mod, x)
    if mod.config.inference_comb_correction:
        out["pitch_hz"], out["pitch_unit"] = apply_comb_correction(mod, x, out["pitch_hz"])
    elif octave_correction:
        out["pitch_hz"], out["pitch_unit"] = apply_octave_correction(mod, x, out["pitch_hz"])
    return out


def _weight_addresses(mod: Modules) -> Tuple[int, ...]:
    return tuple(p.data_ptr() for p in mod.encoder.parameters())


class PredictGraph:
    """``_predict_body`` for one input shape and one ``octave_correction``
    captured into a CUDA graph under ``inference_mode`` (the JAX package's
    ``jax.jit(partial(predict, mod))``, compiled per shape).

    The request is copied into a static input buffer (host-to-device from
    numpy or a CPU tensor, device-to-device from a CUDA tensor), the graph
    is replayed, and the outputs are cloned out of the graph's buffers, so
    a call's tensors are not overwritten by the next request. The weights
    are read where they are: an in-place ``load_state_dict`` is what the
    next replay uses. The graph keeps no reference to the ``Modules``; it
    records the weights' addresses, and ``predict`` captures again when a
    parameter tensor was replaced (``reads``). Warmed up on a side stream
    first, so the capture launches nothing new (the device constants, the
    CQT tile plan, the synth's tables, cuFFT plans); a capture that fails
    raises. Launch counts advance per replay as in ``TrainGraph``.
    """

    def __init__(self, mod: Modules, x: torch.Tensor, octave_correction: bool):
        if mod.device.type != "cuda":
            raise ValueError(f"PredictGraph: a CUDA graph needs the model on the GPU "
                             f"(model on {mod.device})")
        dev = mod.device
        self.addresses = _weight_addresses(mod)
        with torch.inference_mode():
            self.x = torch.empty(tuple(x.shape), dtype=torch.float32, device=dev)
            self.x.copy_(x)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP):
                    _predict_body(mod, self.x, octave_correction)
            torch.cuda.current_stream(dev).wait_stream(side)
            before = launches_lib.read()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = _predict_body(mod, self.x, octave_correction)
        self.launches = launches_lib.delta(before, launches_lib.read())
        launches_lib.write(before)

    def reads(self, mod: Modules) -> bool:
        """Whether ``mod``'s weights are still the tensors it captured."""
        return _weight_addresses(mod) == self.addresses

    def __call__(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            self.x.copy_(x)
            self.graph.replay()
            launches_lib.add(self.launches)
            return {k: v.clone() for k, v in self.out.items()}


def predict(mod: Modules, x, octave_correction: Optional[bool] = None
            ) -> Dict[str, torch.Tensor]:
    """Deployment inference entry: pitch + harmonic amplitudes for audio x
    ([batch, n_samples], array or tensor), computed on ``mod.device``.

    Unlike the eval path, the unsupervised corrections rewrite the returned
    prediction: the comb rule under ``cfg.inference_comb_correction``, else
    the octave rule under ``octave_correction`` (default
    ``cfg.inference_octave_correction``).

    On the GPU each (input shape, ``octave_correction``) is one
    ``PredictGraph`` in ``mod.serve_graphs``, captured at its first request
    and replayed for the next; on the CPU the same body runs eagerly.
    """
    if octave_correction is None:
        octave_correction = mod.config.inference_octave_correction
    octave_correction = bool(octave_correction)
    if mod.device.type != "cuda":
        with torch.inference_mode():
            x = torch.as_tensor(x, dtype=torch.float32, device=mod.device)
            return _predict_body(mod, x, octave_correction)
    x = torch.as_tensor(x, dtype=torch.float32)
    key = (tuple(x.shape), octave_correction)
    graph = mod.serve_graphs.get(key)
    if graph is None or not graph.reads(mod):
        mod.serve_graphs.pop(key, None)  # a replaced weight: free the old graph first
        graph = mod.serve_graphs[key] = PredictGraph(mod, x, octave_correction)
    return graph(x)


# ---------------------------------------------------------------------------
# The training run
# ---------------------------------------------------------------------------


def probe_generator(cfg: ExperimentConfig, probe: int) -> torch.Generator:
    """The CPU generator that initialises init probe ``probe``'s encoder:
    seeded with the first 64-bit word of ``np.random.SeedSequence((cfg.seed,
    1000 + probe))``. (The JAX package folds ``1000 + probe`` into its
    ``PRNGKey(cfg.seed)``; that draw cannot be reproduced in PyTorch, so a
    probe's parameters differ from JAX's by design.)"""
    word = np.random.SeedSequence((cfg.seed, 1000 + probe)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(word))


def _params_copy(mod: Modules) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in mod.encoder.state_dict().items()}


def train(
    cfg: ExperimentConfig,
    max_steps: Optional[int] = None,
    log_every: int = 50,
    checkpoint_dir: Optional[str] = None,
    log_file: Optional[str] = None,
    splits: Optional[Dict[str, data_lib.SplitArrays]] = None,
    resume_from: Optional[str] = None,
    figure_dir: Optional[str] = None,
    device: DeviceLike = None,
    kernels: Kernels = "auto",
) -> Tuple[Modules, TrainState, Dict[str, float]]:
    """The training run of ``sot_tpu/training/trainer.py:train``, on
    ``device`` (default: the GPU; raises if there is none) with the kernel
    gates ``kernels``. Returns ``(mod, state, best_metrics)``: ``mod.encoder``
    holds the parameters of the lowest val LSD (a copy taken at that
    evaluation), not the last ones, as the JAX package returns them;
    ``state`` holds the last optimizer, schedule, generator and step;
    ``best_metrics`` is that evaluation's val record.

    The encoder is initialised from a CPU generator seeded with
    ``cfg.seed`` (the JAX package's Flax init from ``PRNGKey(cfg.seed)``
    cannot be reproduced, so the parameters differ from JAX's by design).

    As in the JAX package:
      * the train split is peak-normalised and kept on the device; an
        epoch is ``n_train // batch_size`` batches in the order
        ``np.random.default_rng(cfg.seed).permutation``, one draw per
        epoch, cut to the steps left; one ``train`` record per epoch (the
        last step's logs, ``step``, ``samples_per_sec``);
      * evaluation on the val split whenever ``step // eval_every_steps``
        grows, and at ``max_steps``: full batches through
        ``make_eval_all``, a trailing partial batch through
        ``make_eval_step``, the batches weighted equally; one ``val``
        record each time; a lower LSD checkpoints the state under
        ``best-lsd``; ``last`` is written at the end;
      * init-probe restarts (``n_init_probes > 1``, ``probe_steps > 0``,
        not resumed): probe i trains a fresh encoder (``probe_generator``)
        with a fresh optimizer for ``probe_steps`` steps in the orders of
        ``default_rng(cfg.seed + i)``, is evaluated and writes a ``probe``
        record; the lowest val LSD goes on from step ``probe_steps``;
      * a resumed run restores the parameters, optimizer, schedule,
        generator and step, then starts the epoch orders again from
        ``default_rng(cfg.seed)``'s first epoch (the JAX package restarts
        its shuffle there too), with the best LSD reset and no probes.

    On the GPU, as the JAX package runs an epoch as one scanned program,
    every chunk of steps is replays of the state's ``TrainGraph`` (captured
    at its first chunk; each probe captures its own) and every evaluation's
    full batches replays of one ``EvalGraph``; a capture that fails raises.
    On the CPU the chunks run the eager ``train_steps``.

    The dropout stream: every mask comes from ``state.generator``, one
    ``torch.Generator`` on the device seeded from ``cfg.seed`` (each probe
    gets its own, seeded the same way), registered with the state's graph,
    and the checkpoint keeps its state, so two resumes from one checkpoint
    draw the same masks on either path. The JAX package keys each step's
    masks by ``fold_in(rng, step)``; doing that here would reseed from the
    host every step, which a captured graph cannot do.

    With ``figure_dir``, each evaluation also draws the figure gallery of
    the val split's first batch under ``<figure_dir>/figures/step<N>/``
    (``log_figures``; it needs matplotlib and raises at the start without
    it). ``log_every`` is accepted for the JAX package's signature and
    unused, as there.
    """
    fig_logger = FigureLogger(figure_dir)
    max_steps = max_steps or cfg.max_steps
    mod = build_modules(cfg, device=device, generator=torch.Generator().manual_seed(cfg.seed),
                        kernels=kernels)
    if splits is None:
        splits = data_lib.dataset_from_config(cfg, device=mod.device)

    state = init_state(mod)
    start_step = 0
    if resume_from:
        start_step = ckpt_lib.restore(resume_from, mod, state)

    eval_step = make_eval_step(mod)
    eval_all = make_eval_all(mod)
    viz_step = make_viz_step(mod) if fig_logger.enabled else None
    bs = cfg.batch_size

    def device_tensor(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=mod.device)

    x_train = device_tensor(data_lib.peak_normalize(splits["train"].x))
    n_train = x_train.shape[0]
    steps_per_epoch = n_train // bs
    if steps_per_epoch == 0:
        raise ValueError(f"train split has {n_train} samples < batch_size {bs}; reduce "
                         f"batch_size or enlarge the dataset")

    def run_chunk(st: TrainState, offsets: np.ndarray) -> Dict[str, torch.Tensor]:
        steps = train_steps_graph if mod.device.type == "cuda" else train_steps
        return steps(mod, st, x_train, offsets)

    val_batches = list(data_lib.iterate_batches(splits["val"], bs, drop_last=False))
    full = [b for b in val_batches if b["x"].shape[0] == bs]
    partial = [b for b in val_batches if b["x"].shape[0] != bs]
    if full:
        val_xs = device_tensor(np.stack([b["x"] for b in full]))
        val_f0s = device_tensor(np.stack([b["frequency"] for b in full]))

    def run_eval() -> Dict[str, float]:
        sums: Dict[str, float] = {}
        count = 0
        if full:
            m = eval_all(val_xs, val_f0s)
            sums = {k: float(v) * len(full) for k, v in m.items()}
            count += len(full)
        for b in partial:
            m = eval_step(device_tensor(b["x"]), device_tensor(b["frequency"]))
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        return {k: v / max(count, 1) for k, v in sums.items()}

    logger = JsonlLogger(log_file)
    try:
        if cfg.n_init_probes > 1 and cfg.probe_steps > 0 and start_step == 0 and not resume_from:
            probes = []
            for i in range(cfg.n_init_probes):
                mod.encoder.reset_parameters(probe_generator(cfg, i))
                st = init_state(mod)
                order_rng = np.random.default_rng(cfg.seed + i)
                remaining = cfg.probe_steps
                while remaining > 0:
                    order = order_rng.permutation(steps_per_epoch)[
                        :min(steps_per_epoch, remaining)]
                    run_chunk(st, order * bs)
                    remaining -= len(order)
                val = run_eval()
                logger.write({"split": "probe", "probe": i, "step": cfg.probe_steps, **val})
                probes.append((val.get("log_spectral_distance", float("inf")),
                               _params_copy(mod), st))
            _, params, state = min(probes, key=lambda t: t[0])
            del probes, st  # the other probes' states and their graphs
            mod.encoder.load_state_dict(params)
            mod.encoder.dropout.generator = state.generator
            start_step = cfg.probe_steps

        best_lsd = float("inf")
        best_metrics: Dict[str, float] = {}
        best_params = _params_copy(mod)
        t0 = time.perf_counter()
        samples_done = 0

        shuffle_rng = np.random.default_rng(cfg.seed)
        step = start_step
        eval_bucket = step // cfg.eval_every_steps
        while step < max_steps:
            epoch_order = shuffle_rng.permutation(steps_per_epoch)
            k = min(steps_per_epoch, max_steps - step)
            logs = run_chunk(state, epoch_order[:k] * bs)
            step += k
            samples_done += k * bs

            record = {key: float(v) for key, v in logs.items()}
            record.update({"step": step,
                           "samples_per_sec": samples_done / (time.perf_counter() - t0)})
            logger.write({"split": "train", **record})

            if step // cfg.eval_every_steps > eval_bucket or step >= max_steps:
                eval_bucket = step // cfg.eval_every_steps
                val = run_eval()
                logger.write({"split": "val", "step": step, **val})
                if viz_step is not None:
                    log_figures(mod, fig_logger, viz_step, step, val_batches[0])
                lsd = val.get("log_spectral_distance", float("inf"))
                if lsd < best_lsd:
                    best_lsd = lsd
                    best_metrics = val
                    best_params = _params_copy(mod)
                    if checkpoint_dir:
                        ckpt_lib.save(checkpoint_dir, mod, state, step, tag="best-lsd")

        if checkpoint_dir:
            ckpt_lib.save(checkpoint_dir, mod, state, step, tag="last")
    finally:
        logger.close()
    mod.encoder.load_state_dict(best_params)
    return mod, state, best_metrics
