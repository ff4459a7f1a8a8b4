#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device  — require CUDA; print the card's name and power limit
  2. build   — compile csrc/cqt.cu and csrc/synth.cu (sm_90a) in parallel
  3. kernels — each kernel against its plain PyTorch version on the card at
               the serving shapes: CQT [64, 4095] -> [64, 16, 570] within
               max|d|/max|ref| <= 1e-4 (f32 vs f32, TF32 off, 32768-term sums
               in another order); synth [64, 16, 20] -> [64, 4096] with
               envelopes bit-equal and audio within atol 2e-2, corr > 0.9999
               (phase prefix summed in another order, ~1 ulp at 1e4 rad)
  4. golden  — the trained SOT-2048 seed-42 weights and 64 clips of
               sot_tpu_torch/golden/: predict on the card against the stored
               JAX CPU outputs (pitch_hz max rel diff <= 1e-3, weights
               max|d| <= 1e-3 * max, share of frames within 50 cents of the
               true f0 equal to within 1/1024)
  5. serving — 4 requests of 64 clips made by the port's data module on the
               card, each answered by predict; launch counts of both kernels
               over exactly these requests; then a window of 32 more
               requests whose rate is all clips over the summed request
               time; a torch.profiler breakdown of one more request; kernel,
               plain and library timings with CUDA events on inputs that
               change between iterations

The last two lines are the card (nvidia-smi name, power.limit) and
{"ok": true, "device": {...}}; the line before them is the per-kernel JSON.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from sot_tpu_torch import data as data_lib
from sot_tpu_torch.configs import get_experiment
from sot_tpu_torch.convert import flax_tree_from_flat, params_from_flax
from sot_tpu_torch.device import set_precision_policy
from sot_tpu_torch.ops.cqt import cqt_bank
from sot_tpu_torch.ops.kernels import _build
from sot_tpu_torch.ops.kernels import cqt as kcqt
from sot_tpu_torch.ops.kernels import synth as ksynth
from sot_tpu_torch.ops.numerics import exp_sigmoid, get_cqt_n_bins
from sot_tpu_torch.ops.oscillator import get_harmonic_frequencies, remove_above_nyquist
from sot_tpu_torch.training.trainer import build_modules, predict

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot2048_seed42_predict.npz")

# H100 SXM data sheet (dense): FP32 on the CUDA cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per (lane, sample) of the synth: f-envelope 3 (sub, mul,
# add), a-envelope 3 (mul, mul, add), Nyquist compare 1, phase increment 1,
# prefix add 1, carry add 1, amplitude product 1, harmonic sum 1 = 12, plus a
# full-range sinf counted as 20 (range reduction + polynomial, an estimate of
# the CUDA math library's instruction count).
SYNTH_FLOPS_PER_SAMPLE = 12 + 20

BATCH = 64
N_REQUESTS = 4          # the smoke's requests: shapes, finiteness, launch counts
WINDOW_REQUESTS = 32    # then a timed serving window, each request on fresh clips
TIMING_ITERS = 20
TIMING_INPUTS = 4


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
    mod.encoder.load_state_dict(params_from_flax(flax_tree_from_flat(g)))
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
    kcqt.launches = 0
    ksynth.launches = 0
    latencies, outs = answer(mod, requests)
    launches = {"cqt_project": kcqt.launches, "synth_render": ksynth.launches}

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


def profile_request(mod, x) -> None:
    """Device time by kernel for one served request (torch.profiler), and the
    device's idle share between its first and last kernel of the request."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predict(mod, x)
        torch.cuda.synchronize()
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        print("[profile] the profiler saw no device events: breakdown not measured")
        return
    busy = sum(by_name.values())
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    print(f"[profile] one request: {len(spans)} device events, busy {busy / 1e3:.4f} ms "
          f"over a {span / 1e3:.4f} ms span (idle share {1.0 - busy / span:.3f})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile] {us / 1e3:9.4f} ms {100.0 * us / busy:5.1f}%  {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    set_precision_policy()

    seconds = _build.build(["cqt", "synth"])
    print(f"[build] nvcc sm_90a, parallel: {json.dumps(seconds)} s")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    cfg = get_experiment("SOT-2048")
    rng = np.random.default_rng(0)
    kernels = [check_cqt(cfg, dev, rng), check_synth(cfg, dev, rng)]
    mod = check_golden(cfg, dev)
    launches, last_request = serve(cfg, mod)
    profile_request(mod, last_request)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        print(f"[timing] {k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms'] if k['library_ms'] is None else round(k['library_ms'], 4)}"
              f" ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}) | {card}")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
