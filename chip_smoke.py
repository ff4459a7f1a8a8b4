#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the SOT-2048 serving
path (predict) and the SOT-2048 train step.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device  — require CUDA; print the card's name and power limit
  2. build   — compile csrc/{cqt,synth,merge,refgrad}.cu (sm_90a) in parallel:
               five kernels (synth.cu holds the forward and the backward)
  3. kernels — each slice-1 kernel against its plain PyTorch version on the
               card at the serving shapes: CQT [64, 4095] -> [64, 16, 570]
               within max|d|/max|ref| <= 1e-4 (f32 vs f32, TF32 off,
               32768-term sums in another order); synth [64, 16, 20] ->
               [64, 4096] with envelopes bit-equal and audio within atol
               2e-2, corr > 0.9999 (phase prefix summed in another order,
               ~1 ulp at 1e4 rad)
  4. golden  — the trained SOT-2048 seed-42 weights and 64 clips of
               sot_tpu_torch/golden/: predict on the card against the stored
               JAX CPU outputs (pitch_hz max rel diff <= 1e-3, weights
               max|d| <= 1e-3 * max, share of frames within 50 cents of the
               true f0 equal to within 1/1024)
  5. serving — 4 requests of 64 clips made by the port's data module on the
               card, each answered by predict; launch counts of both kernels
               over exactly these requests; then a window of 32 more
               requests whose rate is all clips over the summed request
               time; a torch.profiler breakdown of one more request
  6. kernels — the three train-step kernels against their plain versions on
               the card: the merge coupling (S per-row rel err <= 1e-5) and
               the reference-convention beta gradient (max|d| <= 2e-5 *
               max|ref|, kinks included, share of bit-equal elements
               printed) on the SOT rows of 64 clips through the trained
               model (1024 rows x 1025 bins); the synth backward from a
               random audio cotangent at [64, 16, 20] (d amplitudes <= 1e-4
               and d frequencies <= 1e-3 of their max)
  7. train-golden — sot_tpu_torch/golden/sot2048_seed42_trainstep.npz (JAX
               on the CPU with the shipped kernel gates), eval mode, the
               golden's 16 clips: the merge and refgrad kernels on the
               golden's 128 real SOT rows against the JAX kernels' outputs
               (W within 3e-5 of the marginal terms, the beta cotangent
               within 2e-5 of its max); compute_loss's loss and both terms
               within 1e-4 rel; each term's gradient per parameter leaf
               (max|d|/max and cosine, limits in GRAD_LIMITS and
               LEAF_COSINE); the three train-step kernels composed with
               cuFFT from the CPU's synth controls against the CPU (d
               amplitudes and d frequencies within 2e-3 of their max); the
               port's compute_loss on the card against the port on the
               CPU, the readings the limits rest on; then five deliberately
               wrong gradients, each of which some gate must reject
  8. train   — the config's dataset generated on the card by the port's data
               module, 4 train steps at batch 64 in train mode (dropout,
               Adam): launch counts of all five kernels, finite loss and
               grad_norm, changed parameters; then a window of 32 more steps
               (median step ms, train frames/s over the summed step time);
               a torch.profiler breakdown of one more step

Kernel, plain and library timings use CUDA events on inputs that change
between iterations. The last three lines are the per-kernel JSON, the card
(nvidia-smi name, power.limit) and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from sot_tpu_torch import data as data_lib
from sot_tpu_torch.configs import get_experiment
from sot_tpu_torch.convert import (flat_from_tree, flax_tree_from_flat, params_from_flax,
                                   params_to_flax)
from sot_tpu_torch.device import set_precision_policy
from sot_tpu_torch.ops.cqt import cqt_bank
from sot_tpu_torch.ops.kernels import _build
from sot_tpu_torch.ops.kernels import cqt as kcqt
from sot_tpu_torch.ops.kernels import merge as kmerge
from sot_tpu_torch.ops.kernels import refgrad as krefgrad
from sot_tpu_torch.models import synths as synths_lib
from sot_tpu_torch.ops import wasserstein as wasserstein_lib
from sot_tpu_torch.ops.kernels import synth as ksynth
from sot_tpu_torch.ops.numerics import exp_sigmoid, get_cqt_n_bins
from sot_tpu_torch.ops.oscillator import get_harmonic_frequencies, remove_above_nyquist
from sot_tpu_torch.ops.wasserstein import clipped_cdfs
from sot_tpu_torch.training import trainer
from sot_tpu_torch.training.trainer import build_modules, predict

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot2048_seed42_predict.npz")
GOLDEN_TRAIN = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot2048_seed42_trainstep.npz")

# H100 SXM data sheet (dense): FP32 on the CUDA cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per (lane, sample) of the synth: f-envelope 3 (sub, mul,
# add), a-envelope 3 (mul, mul, add), Nyquist compare 1, phase increment 1,
# prefix add 1, carry add 1, amplitude product 1, harmonic sum 1 = 12, plus a
# full-range sinf counted as 20 (range reduction + polynomial, an estimate of
# the CUDA math library's instruction count).
SYNTH_FLOPS_PER_SAMPLE = 12 + 20
# The backward per (lane, sample): envelopes 7 (as the forward, without the
# harmonic sum), phase increment and prefix 2, sin and cos 40 (20 each, as
# above), d_env_a 2 (product, Nyquist mask), d_phase 2, suffix sum 1,
# d_env_f scale 1, the transposed taps to frames 9 (bilinear: sub, mul, add
# and mul, add; window: two mul-adds).
SYNTH_BWD_FLOPS_PER_SAMPLE = 7 + 2 + 40 + 2 + 2 + 1 + 1 + 9

BATCH = 64
N_REQUESTS = 4          # the smoke's requests: shapes, finiteness, launch counts
WINDOW_REQUESTS = 32    # then a timed serving window, each request on fresh clips
TIMING_ITERS = 20
TIMING_INPUTS = 4
TRAIN_STEPS = 4         # the smoke's train steps: launch counts, finiteness
WINDOW_STEPS = 32       # then a timed window of train steps
# [train-golden] gradients against JAX, for each term and each parameter
# leaf: max|d|/max <= GRAD_LIMITS[term] and cosine >= LEAF_COSINE[term]. The
# limits rest on the card's readings against the port's own CPU run (printed
# by compare_devices): the card's cuDNN forward moves the synth controls by
# ~1e-6 relative, which the frequency gradient (cos(phase) integrated over
# 4096 samples) amplifies to ~1e-1 of the frequency head's gradient max, and
# cuFFT's spectra move the quantile cap on other rows than the CPU's. Every
# control in GRAD_CONTROLS must fail them.
GRAD_LIMITS = {"w1d": 0.2, "mss": 0.15, "total": 0.25}
LEAF_COSINE = {"w1d": 0.995, "mss": 0.998, "total": 0.99}
GRAD_TERMS = {"w1d": "loss/Wasserstein1D", "mss": "loss/MSSLoss", "total": "loss/total"}
# the SOT kernels on JAX's own rows: W over the marginal terms, the beta
# cotangent over its max (tests/test_refgrad.py)
SOT_ROW_LIMITS = (3e-5, 2e-5)
# the composed kernels against the CPU from identical synth controls: d
# amplitudes and d frequencies, max|d| over their max
COMPOSED_LIMIT = 2e-3


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def roofline(flops: float, bytes_moved: float):
    """(bound_ms, bound_by): the larger of the operations over the FP32 peak
    and the bytes over the memory rate."""
    ops_s, bytes_s = flops / PEAK_FP32_FLOPS, bytes_moved / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def median_ms(fn, inputs) -> float:
    """Median of per-call CUDA-event times, cycling through ``inputs``."""
    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    events = []
    for i in range(TIMING_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        args = inputs[i % len(inputs)]
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def synth_controls(rng: np.random.Generator, dev: torch.device, sr: int):
    """Serving-shape synth controls: exp-sigmoid amplitudes, harmonic
    frequencies of f0 in the model's range, frame-rate Nyquist mask."""
    logits = torch.from_numpy(rng.standard_normal((BATCH, 16, 20)).astype(np.float32))
    f0 = torch.from_numpy(rng.uniform(33.0, 2000.0, (BATCH, 16, 1)).astype(np.float32))
    freqs = get_harmonic_frequencies(f0, 20)
    amps = remove_above_nyquist(freqs, exp_sigmoid(logits), sr)
    return amps.to(dev).contiguous(), freqs.to(dev).contiguous()


def check_cqt(cfg, dev, rng):
    n_bins = get_cqt_n_bins(cfg.sample_rate, cfg.cqt_fmin, cfg.cqt_bins_per_semitone)
    bank = cqt_bank(cfg.sample_rate, cfg.cqt_fmin, n_bins, 12 * cfg.cqt_bins_per_semitone,
                    1.0, dev)
    width, hop, n_out = bank.shape[0], cfg.cqt_hop_length, 2 * n_bins
    n_frames = (cfg.n_samples - 1) // hop + 1

    def padded():
        x = rng.uniform(-0.9, 0.9, (BATCH, cfg.n_samples - 1)).astype(np.float32)
        return torch.nn.functional.pad(torch.from_numpy(x).to(dev),
                                       (width // 2, width // 2)).contiguous()

    xpad = padded()
    got = kcqt.cqt_project(xpad, bank, hop, n_frames, n_out)
    ref = kcqt.cqt_project_plain(xpad, bank, hop, n_frames, n_out)
    torch.cuda.synchronize()
    require(got.shape == (BATCH, n_frames, n_out), f"cqt shape {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    print(f"[kernels] cqt {tuple(xpad.shape)} -> {tuple(got.shape)}: "
          f"max|d| {err:.3e}, max|d|/max|ref| {rel:.3e} (limit 1e-4)")
    require(bool(torch.isfinite(got).all()) and rel <= 1e-4, "cqt kernel disagrees")

    inputs = [(padded(), bank, hop, n_frames, n_out) for _ in range(TIMING_INPUTS)]
    ms = median_ms(kcqt.cqt_project, inputs)
    plain_ms = median_ms(kcqt.cqt_project_plain, inputs)
    bank_c = bank[:, :n_out].contiguous()
    lib_inputs = [(a[0].unfold(1, width, hop)[:, :n_frames].contiguous(), bank_c)
                  for a in inputs]
    library_ms = median_ms(torch.matmul, lib_inputs)

    # The function needs only the bank's non-zero support: each output is a
    # sum over the support of its column, so the bound counts 2 * rows * nnz
    # operations and nnz bank entries read once.
    m_rows = BATCH * n_frames
    nnz = int(torch.count_nonzero(bank[:, :n_out]))
    bound_ms, bound_by = roofline(2.0 * m_rows * nnz,
                                  4.0 * (xpad.numel() + nnz + m_rows * n_out))
    dense_flops = 2.0 * m_rows * width * n_out
    dense_ms, _ = roofline(dense_flops, 4.0 * (xpad.numel() + width * n_out + m_rows * n_out))
    print(f"[timing] cqt_project: bank non-zero share {nnz / (width * n_out):.4f} "
          f"({nnz} of {width * n_out}); bound {bound_ms:.4f} ms over the non-zero "
          f"support; the dense product the kernel computes is {dense_flops / 1e9:.2f} "
          f"GFLOP, dense bound {dense_ms:.4f} ms")
    return {
        "name": "cqt_project", "route": "cuda", "source": "sot_tpu_torch/csrc/cqt.cu",
        "replaces": "sot_tpu/ops/pallas/cqt.py:52",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_synth(cfg, dev, rng):
    sr, t = cfg.sample_rate, cfg.n_samples
    amps, freqs = synth_controls(rng, dev, sr)
    audio, env_f, env_a = ksynth.synth_render(amps, freqs, t, sr, debug_envelopes=True)
    ref_f, ref_a = ksynth.synth_envelopes_plain(amps, freqs, t, sr)
    cpu_f, cpu_a = ksynth.synth_envelopes_plain(amps.cpu(), freqs.cpu(), t, sr)
    ref = ksynth.synth_render_plain(amps, freqs, t, sr)
    torch.cuda.synchronize()
    bit_equal = (torch.equal(env_f, ref_f) and torch.equal(env_a, ref_a)
                 and torch.equal(env_f.cpu(), cpu_f) and torch.equal(env_a.cpu(), cpu_a))
    err = float((audio - ref).abs().max())
    corr = float(np.corrcoef(audio.cpu().numpy().ravel(), ref.cpu().numpy().ravel())[0, 1])
    print(f"[kernels] synth {tuple(amps.shape)} -> {tuple(audio.shape)}: envelopes "
          f"bit-equal {bit_equal} (card plain and CPU plain), audio max|d| {err:.3e} "
          f"(limit 2e-2), corr {corr:.7f} (limit 0.9999)")
    require(bit_equal, "synth envelopes are not bit-equal to the plain version")
    require(err <= 2e-2 and corr > 0.9999, "synth audio disagrees")
    hz_above = float((freqs >= sr / 2).float().mean())
    print(f"[kernels] synth: share of sinusoid-frames at/above Nyquist {hz_above:.3f}")

    inputs = [synth_controls(rng, dev, sr) + (t, sr) for _ in range(TIMING_INPUTS)]
    ms = median_ms(ksynth.synth_render, inputs)
    plain_ms = median_ms(ksynth.synth_render_plain, inputs)
    b, f, k = amps.shape
    # inputs: controls, the lo/frac tables and the window; output: the audio
    bound_ms, bound_by = roofline(float(b * k * t * SYNTH_FLOPS_PER_SAMPLE),
                                  4.0 * (2 * b * f * k + 2 * t + 2 * (t // f) + b * t))
    return {
        "name": "synth_render", "route": "cuda", "source": "sot_tpu_torch/csrc/synth.cu",
        "replaces": "sot_tpu/ops/pallas/synth.py:140",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def within_50_cents(pitch_hz: np.ndarray, f0: np.ndarray) -> np.ndarray:
    cents = 1200.0 * np.abs(np.log2(np.maximum(pitch_hz, 1e-6) / f0[:, None, :]))
    return cents < 50.0


def check_golden(cfg, dev):
    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    mod = build_modules(cfg, device=dev)
    load_golden_weights(mod)
    out = predict(mod, g["x"])
    pitch = out["pitch_hz"].cpu().numpy()
    weights = out["weights"].cpu().numpy()
    require(pitch.shape == g["pitch_hz"].shape and weights.shape == g["weights"].shape,
            "golden output shapes")
    require(bool(np.isfinite(pitch).all() and np.isfinite(weights).all()),
            "non-finite golden outputs")
    p_rel = float(np.max(np.abs(pitch - g["pitch_hz"]) / np.abs(g["pitch_hz"])))
    w_rel = float(np.max(np.abs(weights - g["weights"])) / np.max(np.abs(g["weights"])))
    share_port = float(within_50_cents(pitch, g["f0"]).mean())
    share_jax = float(within_50_cents(g["pitch_hz"], g["f0"]).mean())
    print(f"[golden] SOT-2048 seed 42 (step {int(g['step'])}), {g['x'].shape[0]} clips: "
          f"pitch_hz max rel diff {p_rel:.3e} (limit 1e-3), weights max|d|/max "
          f"{w_rel:.3e} (limit 1e-3); frames within 50 cents: port {share_port:.6f}, "
          f"JAX CPU {share_jax:.6f}")
    require(p_rel <= 1e-3 and w_rel <= 1e-3, "golden outputs disagree")
    require(abs(share_port - share_jax) <= 1.0 / 1024 + 1e-12,
            "golden accuracy shares differ by more than one frame in 1024")
    return mod


def make_requests(cfg, dev, n: int, seed: int):
    """``n`` requests of BATCH peak-normalised clips from the port's data
    module, rendered on the card."""
    signals, _, _ = data_lib.generate_sinusoid_dataset(
        seed=seed, size=n * BATCH, n_samples=cfg.n_samples, render_batch=BATCH, device=dev)
    torch.cuda.synchronize()
    return np.split(data_lib.peak_normalize(signals).astype(np.float32), n)


def answer(mod, requests):
    """Answer each request with predict; host-clock ms of each, ending in a
    device synchronisation."""
    latencies, outs = [], []
    for x in requests:
        t0 = time.perf_counter()
        outs.append(predict(mod, x))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    return latencies, outs


def serve(cfg, mod):
    requests = make_requests(cfg, mod.device, N_REQUESTS, seed=1000)
    reset_launches()
    latencies, outs = answer(mod, requests)
    launches = {"cqt_project": kcqt.launches, "synth_render": ksynth.launches}
    require(ksynth.backward_launches == 0, "serving launched the synth backward")

    for out in outs:
        require(tuple(out["pitch_hz"].shape) == (BATCH, 16, 1)
                and tuple(out["weights"].shape) == (BATCH, 16, 20)
                and tuple(out["x_hat"].shape) == (BATCH, cfg.n_samples),
                "serving output shapes")
        require(all(bool(torch.isfinite(v).all()) for v in out.values()),
                "non-finite serving outputs")
    print(f"[serving] {N_REQUESTS} requests x {BATCH} clips: latency ms "
          f"{', '.join(f'{v:.3f}' for v in latencies)}")
    print(f"[serving] launches during the requests: {launches}")
    require(all(v > 0 for v in launches.values()), "a kernel was not launched")

    # The rate counts every timed request, slow ones included.
    window, _ = answer(mod, make_requests(cfg, mod.device, WINDOW_REQUESTS, seed=2000))
    total = sum(window)
    print(f"[serving] window of {WINDOW_REQUESTS} requests x {BATCH} clips: "
          f"{WINDOW_REQUESTS * BATCH} clips in {total:.3f} ms of summed request time = "
          f"{WINDOW_REQUESTS * BATCH / total * 1e3:.1f} clips/s; latency ms median "
          f"{statistics.median(window):.3f}, min {min(window):.3f}, max {max(window):.3f}")
    print(f"[serving] window latencies ms: {', '.join(f'{v:.3f}' for v in window)}")
    return launches, requests[-1]


def profile_device(what: str, fn, top: int = 12):
    """Device time by kernel for one call of ``fn`` (torch.profiler), and the
    device's idle share between its first and last kernel. Returns the busy
    ms (None when the profiler saw no device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        print(f"[profile] {what}: the profiler saw no device events: breakdown not measured")
        return None
    busy = sum(by_name.values())
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    print(f"[profile] {what}: {len(spans)} device events, busy {busy / 1e3:.4f} ms "
          f"over a {span / 1e3:.4f} ms span (idle share {1.0 - busy / span:.3f})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[profile] {us / 1e3:9.4f} ms {100.0 * us / busy:5.1f}%  {name[:90]}")
    return busy / 1e3


def load_golden_weights(mod, path=GOLDEN):
    with np.load(path) as z:
        mod.encoder.load_state_dict(params_from_flax(flax_tree_from_flat(
            {k: z[k] for k in z.files if k.startswith("params/")})))


def max_rel(got, ref) -> float:
    got, ref = (t.detach().cpu().numpy() if torch.is_tensor(t) else t for t in (got, ref))
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))


def sot_rows_errors(g, dev):
    """The merge and refgrad kernels on the clipped CDFs of real SOT rows
    (JAX's spectra: identical inputs, where the gradient convention must
    match exactly) against the JAX Pallas kernels' outputs (interpret mode,
    CPU): W's max|d| over the largest marginal term, the beta cotangent's
    max|d|/max, and the cotangent's bit-equal share."""
    alpha, beta, gaug = (torch.from_numpy(g[k]).to(dev)
                         for k in ("sot_alpha", "sot_beta", "sot_gaug"))
    rows = alpha.shape[0]
    w = kmerge.sot_w2_merge(alpha, beta, gaug).cpu().numpy()
    db = krefgrad.ref_grad_beta(alpha, beta, gaug,
                                torch.full((rows,), 1.0 / rows, device=dev)).cpu().numpy()
    a, b, x2 = g["sot_alpha"], g["sot_beta"], g["sot_gaug"] ** 2
    marg = ((a - np.pad(a, ((0, 0), (1, 0)))[:, :-1]) @ x2
            + (b - np.pad(b, ((0, 0), (1, 0)))[:, :-1]) @ x2)
    return (float(np.abs(w - g["sot_w"]).max() / marg.max()), max_rel(db, g["sot_db"]),
            float(np.mean(db == g["sot_db"])))


def loss_and_grads(mod, x):
    """compute_loss in eval mode: ({term: loss}, {term: {flax leaf: grad}},
    dL_W1D/dx_hat, the forward's outputs)."""
    _, (logs, out) = trainer.compute_loss(mod, x, train=False)
    dx_hat = torch.autograd.grad(logs["loss/Wasserstein1D"], out["x_hat"], retain_graph=True)[0]
    names, params = zip(*mod.encoder.named_parameters())
    losses, grads = {}, {}
    for tag, term in GRAD_TERMS.items():
        # a control can cut a leaf from the graph: its gradient is then zero
        gr = torch.autograd.grad(logs[term], params, retain_graph=True, allow_unused=True)
        gr = [torch.zeros_like(p) if d is None else d for d, p in zip(gr, params)]
        losses[tag] = float(logs[term].detach())
        grads[tag] = flat_from_tree(params_to_flax(dict(zip(names, gr)))["params"])
    return losses, grads, dx_hat.detach(), out


def leaf_readings(grads, g):
    """{term: {flax leaf: (max|d|/max, cosine)}} against the golden's JAX
    gradients, and the [(term, leaf)] outside the limits."""
    readings, misses = {}, []
    for tag in GRAD_TERMS:
        readings[tag] = {}
        for name, got in sorted(grads[tag].items()):
            ref = g[f"grad_{tag}/{name}"]
            require(got.shape == ref.shape and bool(np.isfinite(got).all()),
                    f"gradient {tag}/{name}: shape or non-finite")
            e, c = readings[tag][name] = (max_rel(got, ref), cosine(got, ref))
            if e > GRAD_LIMITS[tag] or c < LEAF_COSINE[tag]:
                misses.append((tag, name))
    return readings, misses


def synth_controls_of(mod, out):
    """The synth's frame-rate (amplitudes, frequencies) of a forward, detached."""
    c = mod.decoder.get_controls(out["weights"].detach(), out["pitch_hz"].detach())
    return c["amplitudes"].contiguous(), c["frequencies"].contiguous()


def loss_terms_from_audio(mod, x, x_hat, keep=None):
    """({loss kind: weighted term}, the SOT rows' clipped CDFs (alpha, beta)
    as numpy) of the train loss of the audio ``x_hat`` against ``x``, as
    compute_loss computes it; SOT rows where ``keep`` is 0 are left out of
    the SOT term's mean."""
    grid = torch.from_numpy(mod.x_pos).to(x.device)
    terms, cdfs = {}, None
    for kind, fn, weight in mod.loss_fns:
        if kind == "mss":
            terms[kind] = weight * fn(x, x_hat)
            continue
        sx, sy = mod.transform(x), mod.transform(x_hat)
        u, v = fn.normalize(sx.reshape(-1, sx.shape[-1]), sy.reshape(-1, sy.shape[-1]))
        with torch.no_grad():
            cdfs = tuple(t.cpu().numpy() for t in
                         clipped_cdfs(grid, u, v, fn.limit_quantile_range)[:2])
        w = wasserstein_lib.wasserstein_same_grid(
            grid, u, v, p=fn.p, limit_quantile_range=fn.limit_quantile_range,
            target_constant=fn.target_constant)
        terms[kind] = weight * torch.mean(w if keep is None else w * keep)
    return terms, cdfs


def composed_grads(mod, x, amps, freqs):
    """(d amplitudes, d frequencies) of the train loss from fixed synth
    controls: the synth, the loss STFT, the SOT and MSS terms."""
    cfg = mod.config
    a = amps.detach().requires_grad_(True)
    f = freqs.detach().requires_grad_(True)
    x_hat = synths_lib.synth_render(a, f, cfg.n_samples, cfg.sample_rate)
    terms, _ = loss_terms_from_audio(mod, x, x_hat)
    da, df = torch.autograd.grad(sum(terms.values()), (a, f), allow_unused=True)
    return (torch.zeros_like(a) if da is None else da,
            torch.zeros_like(f) if df is None else df)


def composed_check(mod, mod_cpu, x_cpu, out_cpu):
    """The three train-step kernels composed (synth forward and backward,
    merge coupling, refgrad) with cuFFT on the card, from the synth controls
    of the port's CPU forward, against the same function on the CPU. Returns
    a function giving (d amplitudes, d frequencies) max|d|/max."""
    amps, freqs = synth_controls_of(mod_cpu, out_cpu)
    ref = composed_grads(mod_cpu, x_cpu, amps, freqs)
    dev = mod.device
    args = (x_cpu.to(dev), amps.to(dev), freqs.to(dev))
    return lambda: tuple(max_rel(d, r) for d, r in zip(composed_grads(mod, *args), ref))


def tie_free_grad_beta(alpha, beta, g, wbar):
    """Another valid subgradient at the kinks, not the plane convention: both
    fills at searchsorted-left and no tie term."""
    P = krefgrad._payloads(alpha, g)
    r_lt = torch.searchsorted(alpha.contiguous(), beta.contiguous(), right=False)
    fill = [torch.gather(torch.nn.functional.pad(Pm, (0, 1)), -1, r_lt) for Pm in P]
    gnext = torch.cat([g[1:], g[-1:]])
    return wbar[:, None] * krefgrad._assemble(fill, fill, torch.zeros_like(beta), beta, P,
                                              g[None, :], gnext[None, :], beta)


def scaled_grad(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t`` with its gradient multiplied by ``s``."""
    t = t.view_as(t)
    t.register_hook(lambda d: d * s)
    return t


def grad_controls():
    """(name, [(module, attribute)], replacement) of deliberately wrong
    gradients; a gate of the train-golden phase must reject each."""
    synth = synths_lib.synth_render
    sot = krefgrad.ref_grad_beta
    on_synth = [(synths_lib, "synth_render")]
    on_sot = [(krefgrad, "ref_grad_beta"), (wasserstein_lib, "ref_grad_beta")]
    return [
        ("synth d frequencies zeroed", on_synth,
         lambda a, f, t, sr: synth(a, f.detach(), t, sr)),
        ("synth d amplitudes zeroed", on_synth,
         lambda a, f, t, sr: synth(a.detach(), f, t, sr)),
        ("synth d frequencies 10% low", on_synth,
         lambda a, f, t, sr: synth(a, scaled_grad(f, 0.9), t, sr)),
        ("SOT beta gradient 10% low", on_sot,
         lambda al, be, g, w: 0.9 * sot(al, be, g, w)),
        ("SOT beta gradient with one-sided ties", on_sot, tie_free_grad_beta),
    ]


def compare_devices(cfg, card, cpu):
    """Readings of the port's compute_loss on the card against the same on
    the CPU, the readings the per-leaf limits against JAX rest on: per-leaf
    gradient differences, the rows whose quantile cap differs, where
    dL/dx_hat differs and what leaving those rows out does to it, and the
    synth gradient's sensitivity to its controls. card, cpu: (mod, x, grads,
    dL_W1D/dx_hat, forward outputs) of each device."""
    mod, x, card_grads, _, card_out = card
    mod_cpu, x_cpu, cpu_grads, cpu_dx, cpu_out = cpu
    for tag in GRAD_TERMS:
        errs = {k: max_rel(card_grads[tag][k], cpu_grads[tag][k]) for k in cpu_grads[tag]}
        worst = max(errs, key=errs.get)
        print(f"[train-golden] card vs CPU (the port on both), {tag}: max|d|/max worst {worst} "
              f"{errs[worst]:.3e}; per leaf "
              + ", ".join(f"{k} {v:.2e}" for k, v in sorted(errs.items())))

    def sot_dx(m, xx, x_hat, keep=None):
        x_hat = x_hat.detach().requires_grad_(True)
        terms, cdfs = loss_terms_from_audio(m, xx, x_hat, keep)
        return torch.autograd.grad(terms["wasserstein"], x_hat)[0].cpu().numpy(), cdfs

    def per_clip(a, b):
        return np.abs(a - b).max(-1) / np.abs(b).max()

    def clip_bin(cdfs):
        """Each row's first bin where beta reaches the cap (where the
        estimate's CDF is clipped)."""
        alpha, beta = cdfs
        return np.argmax(beta[:, :-1] >= alpha[:, -1:], axis=1)

    dx_card, cdfs_card = sot_dx(mod, x, card_out["x_hat"])
    dx_cpu, cdfs_cpu = sot_dx(mod_cpu, x_cpu, cpu_out["x_hat"])
    cap_card, cap_cpu = cdfs_card[0][:, -1], cdfs_cpu[0][:, -1]
    d = np.abs(cap_card - cap_cpu) / cap_cpu
    jump = [int(r) for r in np.nonzero(d > 1e-6)[0]]
    frames = card_out["pitch_hz"].shape[1]
    clips = per_clip(dx_card, dx_cpu)
    top = int(np.argmax(clips))
    keep = torch.from_numpy((d <= 1e-6).astype(np.float32))
    kept = per_clip(sot_dx(mod, x, card_out["x_hat"], keep.to(x.device))[0],
                    sot_dx(mod_cpu, x_cpu, cpu_out["x_hat"], keep)[0])
    print(f"[train-golden] card vs CPU: quantile cap differs on {np.count_nonzero(d)} of "
          f"{len(d)} rows, by more than 1e-6 rel on {len(jump)} (largest {d.max():.3e}), rows "
          f"(clip, frame) {[(r // frames, r % frames) for r in jump]}; dL_W1D/dx_hat "
          f"max|d|/max {clips.max():.3e} on clip {top} (its frames with a cap jump: "
          f"{[r % frames for r in jump if r // frames == top]}), the other clips at most "
          f"{np.delete(clips, top).max():.3e}; with the {len(jump)} rows left out of the "
          f"SOT mean on both devices: clip {top} {kept[top]:.3e}, all clips at most "
          f"{kept.max():.3e}")
    shift = np.abs(clip_bin(cdfs_card).astype(np.int64) - clip_bin(cdfs_cpu))
    x_hat_cpu = card_out["x_hat"].detach().cpu()
    same = per_clip(dx_card, sot_dx(mod_cpu, x_cpu, x_hat_cpu)[0])
    print(f"[train-golden] card vs CPU: x_hat max|d|/max per clip max "
          f"{per_clip(x_hat_cpu.numpy(), cpu_out['x_hat'].detach().numpy()).max():.3e}; the "
          f"bin where beta reaches the cap moves on {np.count_nonzero(shift)} rows, by up to "
          f"{shift.max()} bins ({shift.reshape(-1, frames)[top].max()} on clip {top}); "
          f"dL_W1D/dx_hat of the SOT term on the CPU from the card's x_hat against the card's: "
          f"max|d|/max {same.max():.3e} (clip {top} {same[top]:.3e})")

    # the SOT rows on the card's x_hat, each device's spectra: where the beta
    # cotangent differs, and the kink flags (ties with an alpha value, and
    # beta's strict increase, refgrad.py's tie and vne) that differ there
    def sot_row_flags(m, xx):
        w1d = next(fn for kind, fn, _ in m.loss_fns if kind == "wasserstein")
        grid = torch.from_numpy(m.x_pos).to(xx.device)
        with torch.no_grad():
            sx, sy = m.transform(xx), m.transform(card_out["x_hat"].detach().to(xx.device))
            u, v = w1d.normalize(sx.reshape(-1, sx.shape[-1]), sy.reshape(-1, sy.shape[-1]))
            alpha, beta, gaug = clipped_cdfs(grid, u, v, w1d.limit_quantile_range)
            db = krefgrad.ref_grad_beta(alpha, beta, gaug, torch.full_like(alpha[:, 0], 1.0))
            tie = (torch.searchsorted(alpha, beta, right=True)
                   > torch.searchsorted(alpha, beta, right=False))
            vne = beta[:, 1:] > beta[:, :-1]
        return (db.cpu().numpy(), tie.cpu().numpy(), vne.cpu().numpy(),
                beta.cpu().numpy())

    db_d, tie_d, vne_d, beta_d = sot_row_flags(mod, x)
    db_c, tie_c, vne_c, beta_c = sot_row_flags(mod_cpu, x_cpu)
    row_err = np.abs(db_d - db_c).max(-1) / np.abs(db_c).max()
    worst = int(np.argmax(row_err))
    moved = np.nonzero(row_err > 1e-3)[0]
    print(f"[train-golden] card vs CPU, the SOT rows of the card's x_hat: the beta cotangent "
          f"differs by more than 1e-3 of its max on {len(moved)} rows of "
          f"{len(np.unique(moved // frames))} clips; worst row (clip, frame) "
          f"{(worst // frames, worst % frames)}: {row_err[worst]:.3e}, its beta "
          f"max|d| {np.abs(beta_d[worst] - beta_c[worst]).max():.3e}, tie flags differing "
          f"{int(np.count_nonzero(tie_d[worst] != tie_c[worst]))}, strict-increase flags "
          f"differing {int(np.count_nonzero(vne_d[worst] != vne_c[worst]))}; over all rows "
          f"{int(np.count_nonzero(tie_d != tie_c))} tie and "
          f"{int(np.count_nonzero(vne_d != vne_c))} strict-increase flags differ")

    (a_cpu, f_cpu), (a_card, f_card) = synth_controls_of(mod_cpu, cpu_out), (
        t.cpu() for t in synth_controls_of(mod, card_out))
    da, df = plain_synth_vjp(a_cpu, f_cpu, cpu_dx, cfg.n_samples, cfg.sample_rate)
    da2, df2 = plain_synth_vjp(a_card, f_card, cpu_dx, cfg.n_samples, cfg.sample_rate)
    ka, kf = ksynth.synth_backward(a_cpu.to(x.device), f_cpu.to(x.device),
                                   cpu_dx.to(x.device).contiguous(), cfg.n_samples,
                                   cfg.sample_rate)
    print(f"[train-golden] card vs CPU: synth controls max|d|/max amplitudes "
          f"{max_rel(a_card, a_cpu):.3e}, frequencies {max_rel(f_card, f_cpu):.3e}; the plain "
          f"synth VJP on the CPU, one cotangent, on the card's controls against the CPU's: "
          f"d amplitudes {max_rel(da2, da):.3e}, d frequencies {max_rel(df2, df):.3e} of their "
          f"max; the synth backward kernel on the CPU's controls and cotangent against that "
          f"VJP: d amplitudes {max_rel(ka, da):.3e}, d frequencies {max_rel(kf, df):.3e}")


def train_golden_gates(g, dev, mod, x, composed):
    """Every gate of the phase: {gate: (passed, readings)}."""
    err_w, err_db, share = sot_rows_errors(g, dev)
    _, grads, _, _ = loss_and_grads(mod, x)
    readings, misses = leaf_readings(grads, g)
    err_a, err_f = composed()
    return {
        "SOT kernels on JAX's rows": (
            err_w <= SOT_ROW_LIMITS[0] and err_db <= SOT_ROW_LIMITS[1],
            f"W {err_w:.3e}, beta cotangent {err_db:.3e} (bit-equal share {share:.6f})"),
        "gradients per leaf against JAX": (
            not misses, f"{len(misses)} leaf readings outside; worst (max|d|/max, cosine) "
            + ", ".join(f"{t} ({max(e for e, _ in v.values()):.3e}, "
                        f"{min(c for _, c in v.values()):.6f})" for t, v in readings.items())),
        "composed kernels against the CPU": (
            err_a <= COMPOSED_LIMIT and err_f <= COMPOSED_LIMIT,
            f"d amplitudes {err_a:.3e}, d frequencies {err_f:.3e}"),
    }


def check_train_golden(cfg, dev):
    """The train step's gradient on ``dev`` against the JAX CPU golden and
    the port on the CPU (eval mode, the golden's 16 clips): the SOT kernels
    on JAX's rows, the loss and its two terms, the gradient of each term per
    parameter leaf, the composed kernels; on the card, the readings against
    the port on the CPU; then every control must fail a gate."""
    with np.load(GOLDEN_TRAIN) as z:
        g = {k: z[k] for k in z.files}
    print(f"[train-golden] {g['x'].shape[0]} clips, JAX gates {g['gates']}")
    mod = build_modules(cfg, device=dev)
    load_golden_weights(mod)
    mod_cpu = build_modules(cfg, device="cpu")
    load_golden_weights(mod_cpu)
    x_cpu = torch.from_numpy(g["x"])
    x = x_cpu.to(dev)

    err_w, err_db, share = sot_rows_errors(g, dev)
    print(f"[train-golden] SOT kernels on the CDFs of JAX's spectra, {g['sot_alpha'].shape[0]} "
          f"real rows x {g['sot_alpha'].shape[1]}: W max|d|/max(marginals) {err_w:.3e} (limit "
          f"{SOT_ROW_LIMITS[0]}); beta cotangent max|d|/max {err_db:.3e} (limit "
          f"{SOT_ROW_LIMITS[1]}), bit-equal share {share:.6f}")
    require(err_w <= SOT_ROW_LIMITS[0] and err_db <= SOT_ROW_LIMITS[1],
            "SOT kernels disagree with JAX on real rows")

    losses, grads, dx, out = loss_and_grads(mod, x)
    readings, misses = leaf_readings(grads, g)
    for tag, r in readings.items():
        ref_loss = float(g[f"loss_{tag}"])
        rel = abs(losses[tag] - ref_loss) / abs(ref_loss)
        worst = max(r, key=lambda k: r[k][0])
        least = min(r, key=lambda k: r[k][1])
        print(f"[train-golden] {tag}: loss port {losses[tag]:.8f} JAX {ref_loss:.8f} (rel "
              f"{rel:.3e}, limit 1e-4); per leaf max|d|/max (limit {GRAD_LIMITS[tag]}) worst "
              f"{worst} {r[worst][0]:.3e}, cosine (limit {LEAF_COSINE[tag]}) least "
              f"{least} {r[least][1]:.6f}; per leaf (max|d|/max, 1 - cosine) "
              + ", ".join(f"{k} {e:.2e} {1.0 - c:.1e}" for k, (e, c) in r.items()))
        require(rel <= 1e-4, f"train-golden {tag} loss disagrees")
    require(not misses, f"train-golden gradients outside the per-leaf limits: {misses}")

    _, cpu_grads, cpu_dx, cpu_out = loss_and_grads(mod_cpu, x_cpu)
    if dev.type == "cuda":
        compare_devices(cfg, (mod, x, grads, dx, out), (mod_cpu, x_cpu, cpu_grads, cpu_dx,
                                                        cpu_out))
    composed = composed_check(mod, mod_cpu, x_cpu, cpu_out)
    err_a, err_f = composed()
    print(f"[train-golden] composed kernels (synth, merge, refgrad, cuFFT) from the CPU's "
          f"synth controls against the same on the CPU: d amplitudes {err_a:.3e}, d "
          f"frequencies {err_f:.3e} of their max (limit {COMPOSED_LIMIT})")
    require(err_a <= COMPOSED_LIMIT and err_f <= COMPOSED_LIMIT,
            "the composed kernels disagree with the CPU")

    for name, targets, fn in grad_controls():
        with contextlib.ExitStack() as stack:
            for module, attr in targets:
                stack.enter_context(mock.patch.object(module, attr, fn))
            gates = train_golden_gates(g, dev, mod, x, composed)
        rejected = [k for k, (ok, _) in gates.items() if not ok]
        print(f"[train-golden] control ({name}): rejected by {rejected}; "
              + "; ".join(f"{k}: {v}" for k, (_, v) in gates.items()))
        require(bool(rejected), f"train-golden control ({name}) passed every gate")
    print(f"[train-golden] cap-rounding rows of the 64-clip batch on the CPU (JAX f32 vs "
          f"float64 CDF sums): {int(g['cap_rows_differ'])} of {int(g['cap_rows'])} differ, "
          f"{int(g['cap_rows_jump'])} by more than 1e-6 rel (largest "
          f"{float(g['cap_jump_max_rel']):.3e}); target CDF rows that JAX's prefix sum makes "
          f"step down: {int(g['cdf_rows_decreasing'])}")


def sot_rows(mod, x):
    """(alpha, beta, gaug) of a batch's SOT-2048 loss rows, as the loss
    computes them: flattop spectra of x and the model's x_hat, squared,
    normalised by x's mass, CDFs clipped at the quantile cap."""
    w1d = next(fn for kind, fn, _ in mod.loss_fns if kind == "wasserstein")
    with torch.no_grad():
        x_hat = trainer.forward(mod, x)["x_hat"]
        sx, sy = mod.transform(x), mod.transform(x_hat)
        u, v = w1d.normalize(sx.reshape(-1, sx.shape[-1]), sy.reshape(-1, sy.shape[-1]))
        grid = torch.from_numpy(mod.x_pos).to(x.device)
        return clipped_cdfs(grid, u, v, w1d.limit_quantile_range)


def check_merge(alpha, beta, gaug, make_inputs):
    cap = alpha[:, -1:]
    x = (gaug[1:] - gaug[:-1]).contiguous()
    a = (cap - alpha[:, :-1]).contiguous()
    b = (cap - beta[:, :-1]).contiguous()
    got = kmerge.coupling(a, b, x)
    ref = kmerge.coupling_plain(a, b, x)
    torch.cuda.synchronize()
    scale = torch.clamp(ref.abs(), min=1e-12 * float(ref.abs().max()))
    rel = float(((got - ref).abs() / scale).max())
    err = float((got - ref).abs().max())
    print(f"[kernels] merge coupling a, b {tuple(a.shape)}, x {x.numel()}: per-row rel err "
          f"max {rel:.3e} (limit 1e-5), max|d| {err:.3e}; rows with S = 0: "
          f"{int((ref == 0).sum())}")
    require(bool(torch.isfinite(got).all()) and rel <= 1e-5, "merge coupling kernel disagrees")

    inputs = []
    for al, be, ga in make_inputs():
        c = al[:, -1:]
        inputs.append(((c - al[:, :-1]).contiguous(), (c - be[:, :-1]).contiguous(),
                       (ga[1:] - ga[:-1]).contiguous()))
    ms = median_ms(kmerge.coupling, inputs)
    plain_ms = median_ms(kmerge.coupling_plain, inputs)
    rows, m = a.shape
    # reads a, b and x once, writes S; per element one binary search of
    # log2(m) compares, the two scans (add, mul-add) and the row sum (mul-add, mul)
    flops = rows * m * (math.log2(m) + 3 + 4)
    bound_ms, bound_by = roofline(flops, 4.0 * (2 * rows * m + m + rows))
    return {
        "name": "merge_coupling", "route": "cuda", "source": "sot_tpu_torch/csrc/merge.cu",
        "replaces": "sot_tpu/ops/pallas/merge.py:221",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def check_refgrad(alpha, beta, gaug, make_inputs):
    rows, n = alpha.shape
    wbar = torch.full((rows,), 1.0 / rows, device=alpha.device)  # the mean's cotangent
    got = krefgrad.ref_grad_beta(alpha, beta, gaug, wbar)
    ref = krefgrad.ref_grad_beta_plain(alpha, beta, gaug, wbar)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    bit_equal = float((got == ref).float().mean())
    kinks = float((torch.searchsorted(alpha, beta, right=True)
                   > torch.searchsorted(alpha, beta, right=False)).float().mean())
    print(f"[kernels] refgrad alpha, beta {tuple(alpha.shape)}: max|d| {err:.3e}, "
          f"max|d|/max|ref| {err / scale:.3e} (limit 2e-5); bit-equal share {bit_equal:.6f}; "
          f"share of queries tied with an alpha value (kinks) {kinks:.4f}")
    require(bool(torch.isfinite(got).all()) and err <= 2e-5 * scale, "refgrad kernel disagrees")

    inputs = [(al, be, ga, wbar) for al, be, ga in make_inputs()]
    ms = median_ms(krefgrad.ref_grad_beta, inputs)
    plain_ms = median_ms(krefgrad.ref_grad_beta_plain, inputs)
    # reads alpha, beta, g and wbar once, writes the cotangent; per query two
    # binary searches of log2(n) compares and the closed form's ~45 operations
    flops = rows * n * (2 * math.log2(n) + 45)
    bound_ms, bound_by = roofline(flops, 4.0 * (2 * rows * n + n + rows + rows * n))
    return {
        "name": "ref_grad_beta", "route": "cuda", "source": "sot_tpu_torch/csrc/refgrad.cu",
        "replaces": "sot_tpu/ops/pallas/refgrad.py:274",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def plain_synth_vjp(amps, freqs, dout, t, sr):
    a = amps.detach().requires_grad_(True)
    f = freqs.detach().requires_grad_(True)
    return torch.autograd.grad(ksynth.synth_render_plain(a, f, t, sr), (a, f), dout)


def check_synth_backward(cfg, dev, rng):
    sr, t = cfg.sample_rate, cfg.n_samples
    amps, freqs = synth_controls(rng, dev, sr)
    dout = torch.from_numpy(rng.standard_normal((BATCH, t)).astype(np.float32)).to(dev)
    d_amps, d_freqs = ksynth.synth_backward(amps, freqs, dout, t, sr)
    ref_a, ref_f = plain_synth_vjp(amps, freqs, dout, t, sr)
    torch.cuda.synchronize()
    rel_a = float((d_amps - ref_a).abs().max() / ref_a.abs().max())
    rel_f = float((d_freqs - ref_f).abs().max() / ref_f.abs().max())
    print(f"[kernels] synth backward {tuple(amps.shape)} from dout {tuple(dout.shape)}: "
          f"d amplitudes max|d|/max {rel_a:.3e} (limit 1e-4), d frequencies max|d|/max "
          f"{rel_f:.3e} (limit 1e-3)")
    require(bool(torch.isfinite(d_amps).all() and torch.isfinite(d_freqs).all())
            and rel_a <= 1e-4 and rel_f <= 1e-3, "synth backward kernel disagrees")

    inputs = []
    for _ in range(TIMING_INPUTS):
        a, f = synth_controls(rng, dev, sr)
        g = torch.from_numpy(rng.standard_normal((BATCH, t)).astype(np.float32)).to(dev)
        inputs.append((a, f, g, t, sr))
    ms = median_ms(ksynth.synth_backward, inputs)
    plain_ms = median_ms(plain_synth_vjp, inputs)
    b, nf, k = amps.shape
    # inputs: controls, lo/frac tables, window, the frame ranges, dout;
    # outputs: the two control cotangents
    bound_ms, bound_by = roofline(float(b * k * t * SYNTH_BWD_FLOPS_PER_SAMPLE),
                                  4.0 * (2 * b * nf * k + 2 * t + 2 * (t // nf) + 2 * (nf + 1)
                                         + b * t + 2 * b * nf * k))
    return {
        "name": "synth_backward", "route": "cuda", "source": "sot_tpu_torch/csrc/synth.cu",
        "replaces": "sot_tpu/ops/pallas/synth.py:159",
        "max_abs_err": float((d_freqs - ref_f).abs().max()), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def reset_launches() -> None:
    kcqt.launches = ksynth.launches = ksynth.backward_launches = 0
    kmerge.launches = krefgrad.launches = 0


def read_launches():
    return {"cqt_project": kcqt.launches, "synth_render": ksynth.launches,
            "synth_backward": ksynth.backward_launches, "merge_coupling": kmerge.launches,
            "ref_grad_beta": krefgrad.launches}


def timed_steps(mod, state, x_all, offsets):
    """Host-clock ms of each train step, each ending in a device synchronisation."""
    times, logs = [], {}
    for lo in offsets:
        t0 = time.perf_counter()
        logs = trainer.train_steps(mod, state, x_all, [lo])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, logs


def train(cfg, dev):
    """The train step at batch 64 from a device-resident dataset."""
    t0 = time.perf_counter()
    splits = data_lib.dataset_from_config(cfg, device=dev)
    x_all = torch.from_numpy(data_lib.peak_normalize(splits["train"].x)).to(dev)
    torch.cuda.synchronize()
    print(f"[train] dataset: {cfg.dataset_size} clips generated on the card, train split "
          f"{tuple(x_all.shape)} resident ({(time.perf_counter() - t0) * 1e3:.1f} ms set-up)")
    mod = build_modules(cfg, device=dev, generator=torch.Generator().manual_seed(cfg.seed))
    state = trainer.init_state(mod)
    before = [p.detach().clone() for p in mod.encoder.parameters()]
    offsets = np.arange(TRAIN_STEPS + WINDOW_STEPS + 1) * BATCH
    require(offsets[-1] + BATCH <= len(x_all), "train split too small for the smoke's steps")

    reset_launches()
    times, logs = timed_steps(mod, state, x_all, offsets[:TRAIN_STEPS])
    launches = read_launches()
    loss, gnorm = float(logs["loss/total"]), float(logs["grad_norm"])
    moved = max(float((p.detach() - q).abs().max())
                for p, q in zip(mod.encoder.parameters(), before))
    print(f"[train] {TRAIN_STEPS} steps x {BATCH} clips: step ms "
          f"{', '.join(f'{v:.3f}' for v in times)}; last loss {loss:.6f} (MSS "
          f"{float(logs['loss/MSSLoss']):.6f}, W1D {float(logs['loss/Wasserstein1D']):.6f}), "
          f"grad_norm {gnorm:.6f}, max parameter change {moved:.3e}")
    print(f"[train] launches during the {TRAIN_STEPS} steps: {launches}")
    require(math.isfinite(loss) and math.isfinite(gnorm), "non-finite train loss or grad_norm")
    require(moved > 0.0, "the parameters did not change")
    require(all(v > 0 for v in launches.values()), "a kernel was not launched by the train step")

    window, logs = timed_steps(mod, state, x_all, offsets[TRAIN_STEPS:-1])
    total = sum(window)
    frames = WINDOW_STEPS * BATCH * 16
    print(f"[train] window of {WINDOW_STEPS} steps x {BATCH} clips x 16 frames: {frames} frames "
          f"in {total:.3f} ms of summed step time = {frames / total * 1e3:.1f} "
          f"train frames/s (SOT-2048 train step, port); step ms median "
          f"{statistics.median(window):.3f}, min {min(window):.3f}, max {max(window):.3f}; "
          f"last loss {float(logs['loss/total']):.6f}")
    print(f"[train] window step ms: {', '.join(f'{v:.3f}' for v in window)}")
    print(f"[train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    busy = profile_device("one train step",
                          lambda: trainer.train_steps(mod, state, x_all, offsets[-1:]), top=30)
    if busy is not None:
        median = statistics.median(window)
        print(f"[train] device busy {busy:.4f} ms of one step against the window's median "
              f"step {median:.3f} ms: idle share {1.0 - busy / median:.3f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    set_precision_policy()

    seconds = _build.build(["cqt", "synth", "merge", "refgrad"])
    print(f"[build] nvcc sm_90a, parallel: {json.dumps(seconds)} s")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    cfg = get_experiment("SOT-2048")
    rng = np.random.default_rng(0)
    kernels = [check_cqt(cfg, dev, rng), check_synth(cfg, dev, rng)]
    mod = check_golden(cfg, dev)
    serving_launches, last_request = serve(cfg, mod)
    profile_device("one served request", lambda: predict(mod, last_request))

    # the train step's kernels on real SOT rows of the trained model
    batches = make_requests(cfg, dev, 1 + TIMING_INPUTS, seed=3000)
    rows = [sot_rows(mod, torch.from_numpy(b).to(dev)) for b in batches]
    alpha, beta, gaug = rows[0]
    kernels += [check_synth_backward(cfg, dev, rng),
                check_merge(alpha, beta, gaug, lambda: rows[1:]),
                check_refgrad(alpha, beta, gaug, lambda: rows[1:])]
    check_train_golden(cfg, dev)

    launches = train(cfg, dev)
    print(f"[serving] launches during the serving requests: {serving_launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        print(f"[timing] {k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms'] if k['library_ms'] is None else round(k['library_ms'], 4)}"
              f" ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), {k['launches']} launches "
              f"over the {TRAIN_STEPS} train steps | {card}")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
