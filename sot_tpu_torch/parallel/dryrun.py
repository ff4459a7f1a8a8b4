"""A multi-rank dry run of the port, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``:

    python -m sot_tpu_torch.parallel.dryrun N [--device cpu|cuda] [--backend gloo|nccl]

spawns N ranks (the ``spawn`` start method; N = 1 runs in this process)
over one process group (NCCL on ``cuda``, one card per rank; Gloo on
``cpu``) and runs, at the JAX dryrun's tiny shapes (``tiny_config``):

  1. the sharded train step on the first mesh shape (``mesh_freqs``) on
     the same global batches (dropout on), each step from the same
     parameters as two references in this process: (a) the
     single-process ``train_step``: the loss within LOSS_REL; its
     gradient's distance and ``grad_norm`` are read, not held (this loss's
     gradient sits on kinks, the SOT quantile cap, the MSS L1 sign, the
     Nyquist mask: batch shapes that round the forward otherwise move it
     by up to ~4e-3 of its max on the CPU); (b) the mesh mean of the
     ranks' gradients, each rank's loss computed here on its rows (and,
     sharding the loss, on its block of the frames of the whole clips'
     STFT): the forward the rank computes, so the reduced gradient and
     ``grad_norm`` are held within GRAD_REL (the backward pass, the halo's
     cotangent and the gradient mean; a dropped halo cotangent reads
     ~9e-2, a mean over 'data' alone ~0.8). The ranks' parameters and
     gradients bit-equal to each other after every step, and with one rank
     (CPU, or ``deterministic`` on the card) parameters, Adam's state, the
     generator and the logs bit-equal to the single-process step's; the
     parameters' distance after the update is read (Adam's first update is
     ~sign(g) * lr whatever the gradient's size);
  2. the same on the second mesh shape, wider on 'freq'; the two meshes'
     first losses within 1e-3 of each other (JAX's dryrun check);
  3. on the mesh of the widest 'freq' axis, when it is above 1: the
     frame-sharded loss STFT against ``stft_magnitude`` (STFT_LIMIT of the
     max), the freq-sharded W against ``wasserstein_1d`` on the whole rows
     (W_REL), the row-sharded same-grid W and its cotangent on the loss's
     route against ``wasserstein_same_grid`` on all rows (W_REL; whether
     bit-equal is read) and the sample-sharded synth against
     ``oscillator_bank(..., use_angular_cumsum=True)`` (SYNTH_ATOL, the JAX
     test's: the two stitch their phase at other boundaries).

It prints the readings as one JSON line, then one ``dryrun_multichip OK``
line. ``run`` returns the readings
(``chip_smoke.py`` calls it at full width with its own config and clips,
and asks for host-clock timings of the one-rank step).

``cuda`` with the default NCCL needs one card per rank (N <=
``torch.cuda.device_count()``) and raises otherwise; ``backend="gloo"``
lets ranks share the card (rank r on card r % count).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from sot_tpu_torch.configs import ExperimentConfig, get_experiment
from sot_tpu_torch.device import DeviceLike, resolve_device

LOSS_REL = 1e-4       # sharded loss against the single-process loss (tests/test_torch_train.py)
GRAD_REL = 1e-4       # reduced gradient (max|d| of the max) and grad_norm against the ranks' mean
MESH_REL = 1e-3       # the two mesh shapes' first losses
STFT_LIMIT = 2e-5     # frame-sharded STFT: max|d| / max|ref|
W_REL = 1e-5          # the sharded W (and the row-sharded cotangent) against one device
SYNTH_ATOL = 1.5e-3   # sample-sharded synth against the single-device angular bank


def tiny_config(batch: int) -> ExperimentConfig:
    """SOT-2048 at the JAX dryrun's shapes: 1024 samples, CQT from 261.6
    Hz, loss STFT 512 / 128, MSS scales (512, 128)."""
    cfg = get_experiment("SOT-2048", batch_size=batch, n_samples=1024, cqt_fmin=261.6,
                         transform_n_fft=512, transform_hop=128)
    return cfg.replace(losses=tuple(
        lc if lc.kind != "mss" else type(lc)(**{**lc.__dict__, "fft_sizes": (512, 128)})
        for lc in cfg.losses))


def mesh_freqs(n: int) -> List[int]:
    """The 'freq' sizes of the meshes to run: 2 when n is even and >= 4,
    else 1 (JAX's first mesh), then twice that where it divides n (JAX's
    second shape, here also when it leaves one data row)."""
    freq = 2 if n % 2 == 0 and n >= 4 else 1
    return [freq, 2 * freq] if n % (2 * freq) == 0 else [freq]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _fresh(cfg: ExperimentConfig, device: torch.device, kernels):
    from sot_tpu_torch.training import trainer

    mod = trainer.build_modules(cfg, device=device, kernels=kernels,
                                generator=torch.Generator().manual_seed(cfg.seed))
    return mod, trainer.init_state(mod)


def _flat_params(mod) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in mod.encoder.parameters()])


def _flat_grads(mod) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for p in mod.encoder.parameters()])


def _same_state(mod_a, st_a, mod_b, st_b, logs_a, logs_b) -> bool:
    """Parameters, Adam's state, the dropout generator and the logs
    bit-equal."""
    same = torch.equal(_flat_params(mod_a), _flat_params(mod_b))
    for sa, sb in zip(st_a.optimizer.state.values(), st_b.optimizer.state.values()):
        same = same and all(torch.equal(sa[k], sb[k]) for k in sa)
    same = same and torch.equal(st_a.generator.get_state(), st_b.generator.get_state())
    return same and all(torch.equal(logs_a[k], logs_b[k]) for k in logs_b)


def _ranks_equal(flat: torch.Tensor, mesh) -> bool:
    out = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(out, flat, group=mesh.group("all"))
    return all(torch.equal(out[0], o) for o in out)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _FramesOfClip:
    """One rank's loss transform, written apart from ``_FrameShardedSTFT``:
    its block of the frames of the whole clips' rfft STFT."""

    def __init__(self, inner, frames: slice):
        self.inner, self.frames = inner, frames

    def __call__(self, audio: torch.Tensor, reduce: bool = False,
                 log: bool = False) -> torch.Tensor:
        from sot_tpu_torch.ops.numerics import safe_log
        from sot_tpu_torch.ops.stft import stft_magnitude

        n_fft, hop = self.inner.n_fft, self.inner.hop_length
        x = stft_magnitude(audio, size=n_fft, overlap=1.0 - hop / n_fft,
                           window=self.inner.window)[:, self.frames]
        require(not reduce, "the reference transform frames only")
        return safe_log(x) if log or self.inner.log else x

    def get_frequencies(self):
        return self.inner.get_frequencies()


def _ranks_mean_grads(ref, ref_st, mesh, x: torch.Tensor):
    """(the mesh mean of the ranks' gradients, that of their losses), each
    rank's loss computed in this process from ``ref``'s parameters on the
    rank's rows, its dropout rows of the global batch's masks, and with a
    'freq' axis above 1 on an STFT domain, its frames. The generator ends
    where it began."""
    from sot_tpu_torch.features import STFT
    from sot_tpu_torch.training import trainer

    cfg = ref.config
    data, freq = mesh.shape["data"], mesh.shape["freq"]
    frames = cfg.n_samples // ref.transform.hop_length if isinstance(ref.transform, STFT) else 0
    gen_state = ref_st.generator.get_state()
    params = list(ref.encoder.parameters())
    grads = torch.zeros_like(torch.cat([p.detach().reshape(-1) for p in params]))
    loss_sum = 0.0
    dropout = ref.encoder.dropout
    for r in range(mesh.size):
        d, f = divmod(r, freq)
        mod = ref
        if freq > 1 and frames:
            block = frames // freq
            mod = dataclasses.replace(ref, transform=_FramesOfClip(
                ref.transform, slice(f * block, (f + 1) * block)))
        rows = x.shape[0] // data
        ref_st.generator.set_state(gen_state)
        ref.encoder.zero_grad(set_to_none=True)
        dropout.shard = (d, data)
        try:
            loss, _ = trainer.compute_loss(
                mod, x[d * rows:(d + 1) * rows], train=True,
                temperature=trainer.temperature_at(cfg, ref_st.step),
                prior_scale=trainer.prior_scale_at(cfg, ref_st.step))
        finally:
            dropout.shard = None
        loss.backward()
        grads += torch.cat([p.grad.reshape(-1) for p in params])
        loss_sum += float(loss.detach())
    ref.encoder.zero_grad(set_to_none=True)
    ref_st.generator.set_state(gen_state)
    return grads / mesh.size, loss_sum / mesh.size


def _mesh_steps(n: int, freq: int, device: torch.device, cfg, kernels, batches, exact: bool):
    """The sharded step on the (n / freq, freq) mesh against the
    single-process step and the ranks' mean computed here, one global batch
    per step, both from the sharded step's parameters."""
    from sot_tpu_torch.ops.kernels import launches as launches_lib
    from sot_tpu_torch.parallel.mesh import make_mesh
    from sot_tpu_torch.parallel.train import make_sharded_train_step
    from sot_tpu_torch.training import trainer

    mesh = make_mesh(n, freq=freq, device=device)
    mod, st = _fresh(cfg, device, kernels)
    ref, ref_st = _fresh(cfg, device, kernels)
    step = make_sharded_train_step(mod, mesh)
    readings: Dict[str, Any] = {"mesh": dict(mesh.shape), "steps": [],
                                "launches": {k: 0 for k in launches_lib.COUNTERS}}
    for k, x in enumerate(batches):
        with torch.no_grad():
            for p, q in zip(ref.encoder.parameters(), mod.encoder.parameters()):
                p.copy_(q)
        before = launches_lib.read()
        logs = step(st, x)
        _sync(device)
        for name, v in launches_lib.delta(before, launches_lib.read()).items():
            readings["launches"][name] += v
        mean_grads, mean_loss = _ranks_mean_grads(ref, ref_st, mesh, x)
        ref_logs = trainer.train_step(ref, ref_st, x)
        loss, ref_loss = float(logs["loss/total"]), float(ref_logs["loss/total"])
        norm, ref_norm = float(logs["grad_norm"]), float(ref_logs["grad_norm"])
        grads, ref_grads = _flat_grads(mod), _flat_grads(ref)

        def rel_max(a, b):
            return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

        def rel(a, b):
            return abs(a - b) / max(abs(b), 1e-30)

        reading = {"loss": loss, "single_loss": ref_loss, "loss_rel": rel(loss, ref_loss),
                   "ranks_mean_loss_rel": rel(loss, mean_loss),
                   "grad_rel": rel_max(grads, mean_grads),
                   "grad_norm": norm,
                   "grad_norm_rel": rel(norm, float(mean_grads.norm())),
                   "single_grad_rel": rel_max(grads, ref_grads),
                   "single_grad_norm_rel": rel(norm, ref_norm),
                   "params_max_abs": float((_flat_params(mod) - _flat_params(ref)).abs().max()),
                   "ranks_bit_equal": _ranks_equal(torch.cat([_flat_params(mod), grads]), mesh)}
        where = f"mesh {dict(mesh.shape)} step {k + 1}"
        require(math.isfinite(loss) and math.isfinite(norm), f"{where}: non-finite loss or grad_norm")
        require(reading["loss_rel"] <= LOSS_REL,
                f"{where}: loss {loss} against the single-process {ref_loss}")
        require(reading["grad_rel"] <= GRAD_REL and reading["grad_norm_rel"] <= GRAD_REL,
                f"{where}: the reduced gradient {reading['grad_rel']:.3e} of the max and "
                f"grad_norm rel {reading['grad_norm_rel']:.3e} from the ranks' mean")
        require(reading["ranks_bit_equal"], f"{where}: the ranks' parameters or gradients differ")
        if exact:
            reading["bit_equal"] = _same_state(mod, st, ref, ref_st, logs, ref_logs)
            require(reading["bit_equal"], f"{where}: the one-rank step is not bit-equal to "
                                          f"the single-process step")
        readings["steps"].append(reading)
    return readings, (mesh, mod, st, ref, ref_st, step)


def _sharded_ops(mesh, cfg, kernels, x: torch.Tensor) -> Dict[str, float]:
    """The four sharded ops against their single-device ops, each reading
    the worst over the mesh's ranks."""
    from sot_tpu_torch.ops.oscillator import oscillator_bank
    from sot_tpu_torch.ops.stft import stft_magnitude
    from sot_tpu_torch.ops.wasserstein import wasserstein_1d, wasserstein_same_grid
    from sot_tpu_torch.parallel.mesh import shard
    from sot_tpu_torch.parallel.sharded_ops import (oscillator_bank_sample_sharded,
                                                    stft_magnitude_frame_sharded,
                                                    wasserstein_1d_freq_sharded,
                                                    wasserstein_same_grid_row_sharded)

    n_fft, hop, window = cfg.transform_n_fft, cfg.transform_hop, cfg.transform_window
    rows = shard(mesh, x.shape[0], ("data",))
    time_chunk = shard(mesh, x.shape[-1], ("freq",))
    spec = stft_magnitude_frame_sharded(x[rows, time_chunk], mesh, size=n_fft,
                                        hop_length=hop, window=window)
    full = stft_magnitude(x, size=n_fft, overlap=1.0 - hop / n_fft, window=window)
    frames = shard(mesh, full.shape[1], ("freq",))
    want = full[rows, frames]
    require(spec.shape == want.shape, f"frame-sharded STFT: {tuple(spec.shape)}")

    bins = full.shape[-1] - 1  # an even split of the bins
    u = full[..., :bins].abs().reshape(-1, bins) + 1e-6
    u = u / u.sum(1, keepdim=True)
    v = u.flip(0)
    grid = torch.linspace(0.0, 1.0, bins, device=x.device)
    w_rows, w_bins = shard(mesh, u.shape[0], ("data",)), shard(mesh, bins, ("freq",))
    w = wasserstein_1d_freq_sharded(grid[w_bins], u[w_rows, w_bins], v[w_rows, w_bins],
                                    mesh, p=2)
    g_rows = grid[None, :].expand(u.shape)
    w_ref = wasserstein_1d(g_rows, g_rows, u_weights=u, v_weights=v, p=2,
                           require_sort=False)[w_rows]

    # the row-sharded same-grid solve on the loss's settings and route (on
    # SOT-2048 under auto: kernels B4 + B5), value and v cotangent
    (lc,) = [lc for lc in cfg.losses if lc.kind == "wasserstein"]
    n_bins = full.shape[-1]
    power = full.reshape(-1, n_bins) ** 2
    u, v = power / power.sum(1, keepdim=True), power.flip(0) / power.sum(1, keepdim=True)
    grid = torch.linspace(0.0, 1.0, n_bins, device=x.device)
    kw = dict(p=lc.p, limit_quantile_range=lc.limit_quantile_range, target_constant=True,
              kernels=kernels)
    r_rows = shard(mesh, u.shape[0], ("data", "freq"))
    v_l, v_s = v[r_rows].clone().requires_grad_(True), v.clone().requires_grad_(True)
    w_l = wasserstein_same_grid_row_sharded(grid, u[r_rows], v_l, **kw)
    (g_l,) = torch.autograd.grad(w_l.sum(), v_l)
    w_s = wasserstein_same_grid(grid, u, v_s, **kw)
    (g_s,) = torch.autograd.grad(w_s.sum(), v_s)
    w_s, g_s = w_s.detach()[r_rows], g_s[r_rows]
    rows_differ = not (torch.equal(w_l.detach(), w_s) and torch.equal(g_l, g_s))

    # 4 harmonics of a random f0 per clip, random amplitudes (seeded)
    rng = np.random.default_rng(0)
    batch = 2 * mesh.shape["data"]
    f0 = rng.uniform(100.0, 900.0, (batch, 1, 1)).astype(np.float32)
    f_env = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        f0 * np.arange(1, 5, dtype=np.float32), (batch, cfg.n_samples, 4)))).to(x.device)
    a_env = torch.from_numpy(rng.uniform(0.1, 1.0, (batch, cfg.n_samples, 4))
                             .astype(np.float32)).to(x.device)
    s_rows, s_chunk = shard(mesh, batch, ("data",)), shard(mesh, cfg.n_samples, ("freq",))
    audio = oscillator_bank_sample_sharded(f_env[s_rows, s_chunk], a_env[s_rows, s_chunk],
                                           mesh, sample_rate=cfg.sample_rate)
    audio_ref = oscillator_bank(f_env, a_env, sample_rate=cfg.sample_rate,
                                use_angular_cumsum=True)[s_rows, s_chunk]
    # each reading's largest over the mesh's ranks (rank 0 holds no carry)
    worst = torch.stack([(spec - want).abs().max(), want.abs().max(),
                         ((w - w_ref).abs() / w_ref.abs().clamp(min=1e-30)).max(),
                         ((w_l - w_s).abs() / w_s.abs().clamp(min=1e-30)).max(),
                         (g_l - g_s).abs().max() / g_s.abs().max().clamp(min=1e-30),
                         torch.tensor(float(rows_differ), device=x.device),
                         (audio - audio_ref).abs().max()]).detach()
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=mesh.group("all"))
    d_stft, ref_stft, w_rel, rows_rel, rows_grad, rows_differ, synth = worst.tolist()
    out = {"stft": d_stft / ref_stft, "w_rel": w_rel, "rows_rel": rows_rel,
           "rows_grad_rel": rows_grad, "rows_bit_equal": not rows_differ,
           "synth_max_abs": synth}
    require(out["stft"] <= STFT_LIMIT, f"frame-sharded STFT: max|d|/max {out['stft']:.3e}")
    require(w_rel <= W_REL, f"freq-sharded W: rel {w_rel:.3e}")
    require(rows_rel <= W_REL and rows_grad <= W_REL,
            f"row-sharded same-grid W: rel {rows_rel:.3e}, cotangent {rows_grad:.3e}")
    require(synth <= SYNTH_ATOL, f"sample-sharded synth: max|d| {synth:.3e}")
    return out


def _timing(state, batches, windows: int, device: torch.device) -> Dict[str, Any]:
    """Host-clock ms per step over ``windows`` steps of the sharded step and
    of the single-device eager step, in turns (sharded, single, single,
    sharded), each window ending in a synchronisation; then the gradient
    mean alone (CUDA events), and the device busy ms of one profiled step
    of each, in turns, with the NCCL kernels in the sharded one and the
    kernels whose mean device ms the sharded step adds most."""
    from torch.profiler import ProfilerActivity, profile

    from sot_tpu_torch.parallel.train import mean_grads
    from sot_tpu_torch.training import trainer

    mesh, mod, st, ref, ref_st, step = state
    runs = {"sharded": lambda x: step(st, x),
            "single": lambda x: trainer.train_step(ref, ref_st, x)}
    ms: Dict[str, List[float]] = {"sharded": [], "single": []}
    for name in ("sharded", "single", "single", "sharded"):
        _sync(device)
        t0 = time.perf_counter()
        for i in range(windows):
            runs[name](batches[i % len(batches)])
        _sync(device)
        ms[name].append((time.perf_counter() - t0) * 1e3 / windows)
    grads = [p.grad for p in mod.encoder.parameters() if p.grad is not None]
    n_bytes = sum(g.numel() * g.element_size() for g in grads)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    mean_grads(grads, mesh)
    start.record()
    for _ in range(20):
        mean_grads(grads, mesh)
    end.record()
    torch.cuda.synchronize(device)
    busy: Dict[str, List[float]] = {"sharded": [], "single": []}
    by_name: Dict[str, Dict[str, float]] = {"sharded": {}, "single": {}}
    for name in ("sharded", "single", "single", "sharded"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runs[name](batches[0])
            torch.cuda.synchronize(device)
        total = 0.0
        for e in prof.events():
            # a user annotation's device span (Adam's step) covers kernels
            # counted on their own, and the gaps between them
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                total += e.time_range.elapsed_us() / 1e3
                by_name[name][e.name] = (by_name[name].get(e.name, 0.0)
                                         + e.time_range.elapsed_us() / 2e3)
        busy[name].append(total)
    nccl = {k: v for k, v in by_name["sharded"].items() if "nccl" in k.lower()}
    extra = {k: by_name["sharded"].get(k, 0.0) - by_name["single"].get(k, 0.0)
             for k in set(by_name["sharded"]) | set(by_name["single"])}
    return {"ms_per_step": ms, "grad_bytes": n_bytes,
            "allreduce_event_ms": start.elapsed_time(end) / 20,
            "profile_busy_ms": busy,
            "profile_nccl_ms": sum(nccl.values()) if nccl else None,
            "profile_nccl_kernels": sorted(nccl),
            "profile_largest_extra_ms": dict(sorted(extra.items(), key=lambda kv: -kv[1])[:4])}


def _sequence(rank: int, n: int, device: torch.device, cfg: ExperimentConfig, kernels,
              batches: np.ndarray, deterministic: bool, timing: int) -> Dict[str, Any]:
    """The dry run on this rank of an initialised group: the checks (under
    ``cudnn.deterministic`` when asked), then the timings (default cuDNN)."""
    xs = [torch.from_numpy(np.ascontiguousarray(b)).to(device) for b in batches]
    exact = n == 1 and (device.type == "cpu" or deterministic)
    readings: Dict[str, Any] = {"ranks": n, "device": str(device),
                                "backend": dist.get_backend(), "meshes": []}
    states = []
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic or old
    try:
        for freq in mesh_freqs(n):
            mesh_readings, state = _mesh_steps(n, freq, device, cfg, kernels, xs, exact)
            readings["meshes"].append(mesh_readings)
            states.append(state)
        losses = [m["steps"][0]["loss"] for m in readings["meshes"]]
        require(max(losses) - min(losses) <= MESH_REL * max(1.0, abs(losses[0])),
                f"mesh-shape disagreement: losses {losses}")
        mesh = states[-1][0]
        if mesh.shape["freq"] > 1:
            readings["ops"] = _sharded_ops(mesh, cfg, kernels, xs[0])
    finally:
        torch.backends.cudnn.deterministic = old
    if timing and n == 1 and device.type == "cuda":
        readings["timing"] = _timing(states[0], xs, timing, device)
    return readings


def _rank(rank: int, n: int, init_method: str, device: str, backend: str,
          cfg: ExperimentConfig, kernels, batches: np.ndarray, deterministic: bool,
          timing: int, out_dir: Optional[str]) -> Dict[str, Any]:
    from sot_tpu_torch.parallel.launch import initialize_distributed

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    elif n > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize_distributed(backend=backend, device=dev, init_method=init_method,
                           world_size=n, rank=rank)
    try:
        readings = _sequence(rank, n, dev, cfg, kernels, batches, deterministic, timing)
    finally:
        dist.destroy_process_group()
    if out_dir is not None and rank == 0:
        with open(os.path.join(out_dir, "readings.json"), "w") as f:
            json.dump(readings, f)
    return readings


def run(n_ranks: int, device: DeviceLike = None, backend: Optional[str] = None,
        cfg: Optional[ExperimentConfig] = None, kernels="auto",
        batches: Optional[np.ndarray] = None, deterministic: bool = False,
        timing: int = 0) -> Dict[str, Any]:
    """Run the dry run on ``n_ranks`` ranks and return rank 0's readings.
    ``device`` defaults to the GPU (raises if there is none).

    ``cfg`` defaults to ``tiny_config(max(2 n, 8))``; ``batches`` [steps,
    batch, n_samples] are the global batches of the steps (default: one,
    generated from seed 0 and peak-normalised). ``deterministic`` sets
    ``cudnn.deterministic`` in every rank for the checks; ``timing`` > 0
    (one rank on the card) adds host-clock windows of that many steps and
    the all-reduce's time, under the default cuDNN. Raises with the
    failing rank's error."""
    from sot_tpu_torch import data as data_lib

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"NCCL needs one card per rank: {n_ranks} ranks, "
                         f"{torch.cuda.device_count()} cards")
    cfg = cfg or tiny_config(max(2 * n_ranks, 8))
    if batches is None:
        signals, _, _ = data_lib.generate_sinusoid_dataset(
            seed=0, size=cfg.batch_size, n_samples=cfg.n_samples, render_batch=cfg.batch_size,
            device=dev)
        batches = data_lib.peak_normalize(signals)[None]
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        args = (n_ranks, init_method, dev.type, backend, cfg, kernels, batches, deterministic,
                timing)
        if n_ranks == 1:
            return _rank(0, *args, None)
        import torch.multiprocessing as mp

        mp.start_processes(_rank, args=args + (tmp,), nprocs=n_ranks, join=True,
                           start_method="spawn")
        with open(os.path.join(tmp, "readings.json")) as f:
            return json.load(f)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, help="the number of ranks")
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="default: cuda (raises without a GPU)")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                        help="default: nccl on cuda, gloo on cpu")
    args = parser.parse_args(argv)
    readings = run(args.n, device=args.device, backend=args.backend)
    print(json.dumps(readings))
    meshes = [m["mesh"] for m in readings["meshes"]]
    loss = readings["meshes"][0]["steps"][0]["loss"]
    print(f"dryrun_multichip OK: {args.n} ranks ({readings['backend']}, "
          f"{readings['device'].split(':')[0]}), meshes={meshes}, train-step loss={loss:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
