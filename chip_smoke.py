#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the SOT-2048 serving
path (predict), the SOT-2048 train step, the SOT-512 family's train step
and evaluation, SOT-2048 evaluation with the pitch corrections, the
training run through the CLI (train, resume, evaluate, predict, probes,
MSS-LogLin's roll-off), and the gated train step (the ``full`` merge route, the
STFT frontend and the conv kernels: ``KernelGates(w2_merge="full",
conv=True, stft_frontend=True)``).

    python3 chip_smoke.py [--ab-parent PATH/{plane,merge,refgrad}.cu ...]

Phases (any failure raises and the script exits non-zero):
  1. device  — require CUDA; print the card's name and power limit
  2. build   — compile csrc/{cqt,synth,merge,refgrad,plane,stft,conv}.cu
               (sm_90a) in parallel: eleven kernels (synth.cu, merge.cu,
               plane.cu and conv.cu hold two each)
  3. kernels — each slice-1 kernel against its plain PyTorch version on the
               card at the serving shapes: CQT [64, 4095] -> [64, 16, 570]
               within max|d|/max|ref| <= 1e-4 (f32-accurate 3xTF32 vs f32,
               32768-term sums in another order), its error against a
               float64 product at most 2x the plain version's, two launches
               bit-equal; synth [64, 16, 20] -> [64, 4096] with
               envelopes and phase bit-equal, two launches bit-equal, audio
               within atol 2e-2, corr > 0.9999 (and whether it is bit-equal
               to the plain terms summed in k order)
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
  6. kernels — the train-step kernels against their plain versions on the
               card: the merge coupling (kernel 4; S per-row rel err <=
               COUPLING_LIMIT, 1e-5) and the reference-convention beta
               gradient (kernel 5; equal under ==, bit for bit where not a
               zero, max|d| <= 2e-5 * max|ref|, kinks included, the zeros'
               signs counted) on the SOT rows of
               64 clips through the trained models at both loss shapes
               ([1024, 1025] / [1024, 1026] and [1024, 257] / [1024, 258]),
               each timed (events and device; kernel 5 beside the pair
               torch.searchsorted, information only); kernel 4 on unsorted
               rows (either side and both), stress rows and edge rows within
               COUPLING_LIMIT, kernel 5 equal on stress rows, edge rows and
               rows whose beta is not sorted; both bit-equal across two
               launches on the real rows of both shapes;
               the synth backward from a random audio cotangent at
               [64, 16, 20] (d amplitudes <= 1e-4 and d frequencies <= 1e-3
               of their max, two launches bit-equal, against a float64 VJP
               at most 2x the plain f32 version's error); the banded-plane
               forward and backward (kernels 6 and 7, alpha_grads both ways,
               p = 2 and 3) bit for bit on dyadic rows at [1024, 258] and
               [1024, 1026], within PLANE_LIMITS on the SOT-512 golden's real
               rows, random sorted rows at [1024, 1026], unsorted rows and
               stress rows (a spike against a spread spectrum both ways,
               beta = alpha, a zero-mass stretch), two launches bit-equal on
               the real rows of both loss shapes; on the golden's rows kernel
               7's beta cotangent against kernel 5's and JAX's _pallas_bwd,
               and the W of kernels 4 and 6 against JAX's (SOT_ROW_LIMITS);
               [timing] of kernels 4-7 at [1024, 258] and 6-7 at [1024, 1026]
               (CUDA events and the profiler's device time; the mu > 0 cells
               per row, the rows on the full-scan path and the walk's slice
               balance), the A/B of the two SOT-512 backward routes (kernel
               5 against kernel 7); with --ab-parent PATH ..., kernels 6 and
               7, 4 and 8 or 5 built from another plane.cu, merge.cu or
               refgrad.cu (an earlier commit's, chosen by file name) against
               this one, the outputs first (kernel 5 equal, kernels 4 and 8
               within COUPLING_LIMIT and COUPLING_GRAD_LIMIT, their ulps
               printed), then timed in turns, old, new, new, old; the gated
               path's kernels:
               the coupling gradient (kernel 8, alpha_grads both ways) at
               both loss shapes ([1024, 1025] and [1024, 257]) on the real
               SOT rows within COUPLING_GRAD_LIMIT, bit for bit on dyadic
               tie rows, on unsorted rows, its binary searches counted; bit
               for bit on its stress rows (all zeros, a = b, one distinct
               value) and at m = 1, 2 and 8192; two launches bit-equal at
               both shapes (with kernels 4 and 5); the STFT frontend (kernel
               9) at each (n_fft, hop) of the gated steps within
               FRONTEND_LIMIT, its error against a float64 projection at
               most 2x the plain version's; the conv forward and dx (kernel 10) and
               weight gradient (kernel 11) at conv1's and the prefilter's
               shapes in f32 (3xTF32) and bf16 within CONV_LIMIT, within 2x
               the plain version's error against float64, two launches
               bit-equal; [timing] of each (CUDA events, profiler device
               time, plain, library events and device time, bound)
  7. train-golden — sot_tpu_torch/golden/sot2048_seed42_trainstep.npz (JAX
               on the CPU with the shipped kernel gates), eval mode, the
               golden's 16 clips: the merge and refgrad kernels on the
               golden's 128 real SOT rows against the JAX kernels' outputs
               (W within 3e-5 of the marginal terms, the beta cotangent
               within 2e-5 of its max) and against their plain versions
               (kernel 4 within COUPLING_LIMIT, kernel 5 equal, kernel 8
               within COUPLING_GRAD_LIMIT);
               compute_loss's loss and both terms
               within 1e-4 rel; each term's gradient per parameter leaf
               (max|d|/max and cosine, limits in GRAD_LIMITS and
               LEAF_COSINE); the three train-step kernels composed with
               cuFFT from the CPU's synth controls against the CPU (d
               amplitudes and d frequencies within 2e-3 of their max); the
               port's compute_loss on the card against the port on the
               CPU, the readings the limits rest on; then five deliberately
               wrong gradients, each of which some gate must reject
  8. train-golden-512 — the same for sot512_seed42_trainstep.npz (SOT-512,
               its committed seed-42 weights, the hybrid route: the merge
               forward and kernel 7), limits GRAD_LIMITS_512 and
               LEAF_COSINE_512, and four controls (the synth's three and
               kernel 7's beta cotangent 10% low)
  9. eval-512 — the port's evaluate with the SOT-512 weights on the predict
               golden's 64 clips against JAX's stored metrics: LSD, MSE,
               MSS and the loss terms within EVAL_REL, the pitch accuracies
               and the octave difference within one frame
 9a. eval-2048 — the same for the SOT-2048 weights in the three forms of
               sot_tpu/cli.py's --final-eval (plain, eval_octave_correction,
               eval_comb_correction) against sot2048_seed42_eval.npz; both
               corrections' clip factors on the golden's pitches times 1,
               0.5, 2, 2/3 and 1.5 equal to JAX's on every clip, the
               quantities their decisions compare within DECISION_REL;
               predict with inference_comb_correction under auto (pitch
               within 1e-3 of JAX's) and GATED (the correction's STFT on
               kernel 9), its comb factors on JAX's pitches equal to JAX's
 9b. train-golden-gated — the same for sot2048_seed42_trainstep_gated.npz
               (JAX with SOT_TPU_W2_MERGE=1, SOT_TPU_STFT_PALLAS=1,
               SOT_TPU_CONV_PALLAS=1) against the port under GATED: kernel 8
               on JAX's rows against JAX's merge-gradient kernel, the full
               route end to end on JAX's spectra (ROUTE_ROW_LIMITS, rows
               whose cap agrees), limits GRAD_LIMITS_GATED and
               LEAF_COSINE_GATED, the encoder's parameter gradients against
               the CPU (ENCODER_LIMIT), and five controls (the synth's three,
               kernel 8's and kernel 11's gradient 10% low)
 10. train   — the config's dataset generated on the card by the port's data
               module, train steps at batch 64 in train mode (dropout,
               Adam), each run's launch counts showing its SOT route, finite
               loss and grad_norm, changed parameters: SOT-2048 (auto: ref,
               kernels 4 + 5) and SOT-512 (auto: hybrid, kernels 4 + 7) 4
               steps then a window of 32 more (median step ms, train
               frames/s over the summed step time) and a torch.profiler
               breakdown of one more; SOT-512-LogF (hybrid) 4 steps; SOT-2048
               under kernels="default" (plane, kernels 6 + 7 at [1024, 1026])
               4 steps, a window of 32 and a profile; SOT-512 under
               kernels="default" (kernels 6 + 7 at [1024, 258]) 4 steps;
               SOT-2048 under GATED (kernels 4 and 8-11, refgrad and the
               plane kernels at 0) 4 steps, a window of 32 and a profile
               (kernel 10 launched 16 times and kernel 11 8 times in the 4
               steps), SOT-512 under GATED 4 steps, SOT-2048 under CONV_BF16
               (auto with the bf16 conv stack, JAX's SOT_TPU_CONV_BF16) 4
               steps; then, information only, the device busy ms of one
               SOT-2048 step under auto (cuDNN f32 convs) beside CONV_F32
               (kernels 10 and 11 in 3xTF32), profiled in turns
 11. train-run — the training run through the CLI, in this process, at full
               width on the config's 4000-clip dataset (a 2800-clip train
               split: 43 steps an epoch at batch 64): cli train SOT-2048
               --kernels auto for 3 epochs, an evaluation after each, and
               --final-eval: train and val records at steps 43, 86 and 129
               with the JAX package's keys, best_metrics.json equal to the val
               record of lowest LSD, best-lsd saved at its step, both
               checkpoint tags, finite test_metrics{,_octcorr,_comb}.json,
               kernels 1-5 launched during the run; the `last` checkpoint
               equal to the in-memory state and restored bit for bit into
               fresh modules and state (parameters, Adam's moments and steps,
               LambdaLR, the dropout generator, the step); two resumes from it
               for one more epoch, each in default_rng(seed).permutation(43)'s
               order (JAX's resume order), their parameters compared; cli
               evaluate of best-lsd on the val split against the best val
               record (EVAL_REL, EVAL_FRAME); cli predict from best-lsd on 64
               clips; SOT-2048-SS-Probes with two probes of one epoch, the run
               going on from the probe of lower val LSD (its parameters and
               its optimizer state); MSS-LogLin 4 train steps and its roll-off
               render on the card against the CPU (the synth's limits), the
               FIR alone within ROLL_OFF_LIMIT; each run's host-clock steps/s
               and samples_per_sec records beside the card line

Kernel, plain and library timings use CUDA events on inputs that change
between iterations, device times torch.profiler; a [profile] line sums the
device busy ms of each profiled request and step. The last three lines are the per-kernel JSON (each
kernel's launches from the run whose route it is on), the card (nvidia-smi
name, power.limit) and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
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

from sot_tpu_torch import cli as cli_lib
from sot_tpu_torch import data as data_lib
from sot_tpu_torch import metrics as metrics_lib
from sot_tpu_torch.configs import get_experiment
from sot_tpu_torch.convert import (flat_from_tree, flax_tree_from_flat, params_from_flax,
                                   params_to_flax)
from sot_tpu_torch.device import set_precision_policy
from sot_tpu_torch.ops.cqt import cqt_bank
from sot_tpu_torch.ops.kernels import _build
from sot_tpu_torch.kernel_gates import PRESETS, KernelGates
from sot_tpu_torch.ops.kernels import conv as kconv
from sot_tpu_torch.ops.kernels import cqt as kcqt
from sot_tpu_torch.ops.kernels import merge as kmerge
from sot_tpu_torch.ops.kernels import plane as kplane
from sot_tpu_torch.ops.kernels import refgrad as krefgrad
from sot_tpu_torch.models import synths as synths_lib
from sot_tpu_torch.ops import fir as fir_lib
from sot_tpu_torch.ops import wasserstein as wasserstein_lib
from sot_tpu_torch.ops.kernels import stft as kstft
from sot_tpu_torch.ops.kernels import synth as ksynth
from sot_tpu_torch.ops.numerics import exp_sigmoid, get_cqt_n_bins
from sot_tpu_torch.ops.oscillator import get_harmonic_frequencies, remove_above_nyquist
from sot_tpu_torch.ops.wasserstein import clipped_cdfs
from sot_tpu_torch.ops.windows import get_window, hann_window
from sot_tpu_torch.training import checkpoint as ckpt_lib
from sot_tpu_torch.training import trainer
from sot_tpu_torch.training.trainer import build_modules, predict

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot2048_seed42_predict.npz")
GOLDEN_TRAIN = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot2048_seed42_trainstep.npz")
GOLDEN_512 = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot512_seed42_trainstep.npz")
GOLDEN_GATED = os.path.join(ROOT, "sot_tpu_torch", "golden",
                            "sot2048_seed42_trainstep_gated.npz")
GOLDEN_EVAL = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot2048_seed42_eval.npz")

# H100 SXM data sheet (dense): FP32 on the CUDA cores, bf16 and TF32 on the
# tensor cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# H100 SXM instruction issue rates at the 1.98 GHz boost clock: 132 SMs x 128
# FP32 lanes (33.5e12 lane-operations/s; the 67 TFLOP/s above counts an FMA
# as two) and 132 x 64 FP64 lanes. A kernel of single FP32 instructions is
# held to the first, its float64 adds to the second as well.
PEAK_FP32_LANE_OPS = 33.5e12
PEAK_FP64_LANE_OPS = 16.7e12
# Operations of the synth forward that the function needs, per (lane,
# sample), as (every sample, every sample up to the lane's last one below
# Nyquist, every sample below Nyquist); the counts of each come from the
# timed inputs (synth_sample_counts). FP32: the f-envelope 3 (sub, mul, add)
# and the Nyquist compare 1 everywhere; the phase increment 1 up to the last
# kept sample (later phases feed no sine); the a-envelope 3 (mul, mul, add),
# a full-range sinf counted as 20 (range reduction + polynomial, an estimate
# of the CUDA math library's instruction count), the amplitude product 1 and
# the harmonic sum 1 where the sample is kept. float64: the prefix add up to
# the last kept sample.
SYNTH_FP32_OPS = (4, 1, 3 + 20 + 1 + 1)
SYNTH_FP64_OPS = (0, 1, 0)
# The backward, the same way. FP32: the f-envelope and compare 4 everywhere;
# up to the last kept sample (d_env_f is 0 after it) the phase increment 1,
# the d_env_f scale 1 and its bilinear taps to frames 5 (sub, mul, add and
# mul, add); where kept the a-envelope 3, sin and cos 40 (20 each, as
# above), d_env_a 1, d_phase 2 and its window taps to frames 4 (two
# mul-adds). float64: the phase prefix and the d_phase suffix adds up to the
# last kept sample.
SYNTH_BWD_FP32_OPS = (4, 1 + 1 + 5, 3 + 40 + 1 + 2 + 4)
SYNTH_BWD_FP64_OPS = (0, 2, 0)

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
# [train-golden-512]: the same gates for the SOT-512 golden (the hybrid
# route: merge forward, banded-plane backward), ~2x the card's readings
# (worst leaf 1.809e-02 / 6.727e-03 / 1.819e-02 for W1D / MSS / total, least
# cosine 0.999971 / 0.999990 / 0.999943): SOT-512's W1D gradient is far less
# sensitive to the card's rounding than SOT-2048's
GRAD_LIMITS_512 = {"w1d": 0.04, "mss": 0.015, "total": 0.04}
LEAF_COSINE_512 = {"w1d": 0.9995, "mss": 0.9998, "total": 0.9995}
# kernel 4 against its plain version: S per row, relative (both sum in
# float64, in other orders and groupings, and round once)
COUPLING_LIMIT = 1e-5
# kernels 6 and 7 against their plain versions on rows that are not dyadic:
# W per row and the cotangents over their max. Both sum the same f32 cell
# products in float64 and round once, so only the order of the float64 sums
# differs.
PLANE_LIMITS = (1e-6, 1e-6)
# [eval-512] against JAX's metrics: LSD, MSE, MSS and the loss terms within
# EVAL_REL relative; the pitch accuracies and the octave difference within
# one frame of the 64 x 16
EVAL_REL = 1e-3
EVAL_FRAME = 1.0 / (BATCH * 16)
# [eval-2048]: the forms of evaluate that sot_tpu/cli.py's --final-eval
# writes (plain, octave-corrected, comb-corrected), and the pitch shifts the
# golden holds the corrections' factors at (every branch fires)
EVAL_FORMS = {"plain": {}, "octcorr": {"eval_octave_correction": True},
              "comb": {"eval_comb_correction": True}}
CORRECTION_SHIFTS = {"1": 1.0, "0.5": 0.5, "2": 2.0, "2/3": 2.0 / 3.0, "1.5": 1.5}
# the quantities the corrections' decisions compare (band peaks, scores,
# the median pitch) against JAX's on the CPU: max|d| over their max
DECISION_REL = 1e-5
# The gated path: the full merge route (kernels 4 + 8), the STFT frontend
# (kernel 9), the k > 1 convs on kernels 10 and 11 with bf16 operands
GATED = KernelGates(w2_merge="full", conv=True, stft_frontend=True)
# the sources --ab-parent takes
AB_SOURCES = ("plane.cu", "merge.cu", "refgrad.cu")
# kernel 8 against its plain version where it is not bit-equal: max|d|/max
# (both sum x in float64, in another order, and round once)
COUPLING_GRAD_LIMIT = 1e-6
# kernel 9 (an f32 FFT) against the plain f32 matmul (TF32 off): max|d|/max
# (both round their sums over n_fft taps in f32, in other orders)
FRONTEND_LIMIT = 1e-5
# kernels 10 and 11 against F.conv1d / conv1d_weight on the same rounded
# operands (TF32 off): max|d|/max (exact products, f32 sums in another order)
CONV_LIMIT = 1e-5
# The conv-stack gate of the JAX package's shipped recipe (SOT_TPU_CONV_BF16)
# on the auto routes: 4 SOT-2048 steps on the card, its loss printed
CONV_BF16 = dataclasses.replace(PRESETS["auto"], conv_bf16=True)
# auto with the k > 1 convs on kernels 10 and 11 in f32 (3xTF32), against
# auto's cuDNN f32 convs: an information-only in-step reading
CONV_F32 = dataclasses.replace(PRESETS["auto"], conv=True, conv_dtype=torch.float32)
# [train-golden-gated]: per leaf against the gated JAX golden, ~1.5x the
# card's readings (worst leaf 3.006e-01 / 5.261e-02 / 2.900e-01 for W1D /
# MSS / total, least cosine 0.990001 / 0.999488 / 0.989517). The W1D
# readings are the CPU's too (3.010e-01): they come from one SOT row whose
# quantile cap moves between the JAX package's blocked f32 CDF sums and the
# port's float64 ones, where the full route's v cotangent moves by 0.92 of
# its max (route_rows_check prints it). The encoder's parameter gradients
# on the card against the CPU: ~2x the card's reading (2.923e-04).
GRAD_LIMITS_GATED = {"w1d": 0.45, "mss": 0.08, "total": 0.45}
LEAF_COSINE_GATED = {"w1d": 0.985, "mss": 0.9992, "total": 0.984}
ENCODER_LIMIT = 6e-4
# the SOT route end to end on JAX's rows whose cap agrees: W and the v
# cotangent, max|d| over their max
ROUTE_ROW_LIMITS = (3e-5, 1e-3)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def roofline(flops: float, bytes_moved: float, peak: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations over ``peak`` (the
    FP32 peak unless given) and the bytes over the memory rate."""
    ops_s, bytes_s = flops / peak, bytes_moved / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def issue_bound(fp32_ops: float, fp64_ops: float, bytes_moved: float):
    """(bound_ms, bound_by, flop_bound_ms) of a kernel of single
    instructions: the largest of all its instructions over the FP32 issue
    rate, its float64 ones over the FP64 rate and the bytes over the memory
    rate; beside it the FLOP-rate figure (every instruction over 67e12)."""
    ops_s = max((fp32_ops + fp64_ops) / PEAK_FP32_LANE_OPS, fp64_ops / PEAK_FP64_LANE_OPS)
    bytes_s = bytes_moved / PEAK_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes",
            roofline(fp32_ops + fp64_ops, bytes_moved)[0])


def device_ms(fn, inputs, kernel, per_call: int = 1) -> float:
    """Mean device time per call of the ``per_call`` distinct CUDA kernels
    whose name contains ``kernel`` (torch.profiler, TIMING_ITERS calls
    cycling through ``inputs``): the kernels alone, without the host's launch
    gap that a CUDA-event time of a microsecond kernel includes. The sum of
    each kernel's mean over the records the profiler gave: it can drop
    records (an H100 run saw 25 of 40, another 8 of 20 three times running),
    so a profile that holds fewer than half of some kernel's launches is
    taken again, up to five times. With
    ``kernel`` None (a library call whose kernels are not ours to name):
    every device record, summed over the calls, from a profile that holds at
    least one record per call (NaN, printed, if five profiles do not)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    warm_up(fn, inputs)
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(TIMING_ITERS):
                fn(*inputs[i % len(inputs)])
            torch.cuda.synchronize()
        us: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.name):
                us.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if kernel is None and sum(len(v) for v in us.values()) >= TIMING_ITERS:
            return sum(sum(v) for v in us.values()) / TIMING_ITERS / 1e3
        counts = sorted(len(v) for v in us.values())
        if kernel is not None and len(us) == per_call and counts[0] >= TIMING_ITERS // 2:
            break
    if kernel is None:
        print(f"[timing] the profiler gave {sum(counts)} device records for {TIMING_ITERS} "
              f"library calls in five tries: their device ms not measured")
        return float("nan")
    require(len(us) == per_call and counts[0] >= TIMING_ITERS // 2,
            f"the profiler saw {counts} launches of {len(us)} {kernel} kernels, "
            f"expected {per_call} x {TIMING_ITERS}")
    if counts != [TIMING_ITERS] * per_call:
        print(f"[timing] the profiler gave {counts} of {TIMING_ITERS} records of the {kernel} "
              f"kernels: their device ms are means over those")
    return sum(statistics.fmean(v) for v in us.values()) / 1e3


def warm_up(fn, inputs, seconds: float = 0.1) -> None:
    """Call ``fn`` back to back, cycling through ``inputs``, for at least
    TIMING_ITERS calls and ``seconds`` of wall time, so that a reading that
    follows starts on a busy card (its clocks up) and not on an idle one."""
    start, i = time.perf_counter(), 0
    while i < TIMING_ITERS or time.perf_counter() - start < seconds:
        fn(*inputs[i % len(inputs)])
        i += 1
        if i % TIMING_ITERS == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()


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


def f64_rel(got: torch.Tensor, ref64: torch.Tensor) -> float:
    """max|got - ref64| / max|ref64| against a float64 computation."""
    return float((got.double() - ref64).abs().max() / ref64.abs().max())


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
    again = kcqt.cqt_project(xpad, bank, hop, n_frames, n_out)
    ref = kcqt.cqt_project_plain(xpad, bank, hop, n_frames, n_out)
    ref64 = torch.matmul(xpad.double().unfold(1, width, hop)[:, :n_frames],
                         bank[:, :n_out].double())
    torch.cuda.synchronize()
    require(got.shape == (BATCH, n_frames, n_out), f"cqt shape {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    rel64, plain64 = f64_rel(got, ref64), f64_rel(ref, ref64)
    print(f"[kernels] cqt {tuple(xpad.shape)} -> {tuple(got.shape)}: "
          f"max|d| {err:.3e}, max|d|/max|ref| {rel:.3e} (limit 1e-4); against float64: "
          f"kernel {rel64:.3e}, plain f32 {plain64:.3e} (limit 2x plain); two launches "
          f"bit-equal {torch.equal(got, again)}")
    require(bool(torch.isfinite(got).all()) and rel <= 1e-4, "cqt kernel disagrees")
    require(rel64 <= 2.0 * plain64, "cqt kernel is less accurate than f32")
    require(torch.equal(got, again), "cqt kernel is not deterministic")

    inputs = [(padded(), bank, hop, n_frames, n_out) for _ in range(TIMING_INPUTS)]
    ms = median_ms(kcqt.cqt_project, inputs)
    dev_ms = device_ms(kcqt.cqt_project, inputs, "cqt_", 2)
    plain_ms = median_ms(kcqt.cqt_project_plain, inputs)
    bank_c = bank[:, :n_out].contiguous()
    lib_inputs = [(a[0].unfold(1, width, hop)[:, :n_frames].contiguous(), bank_c)
                  for a in inputs]
    library_ms = median_ms(torch.matmul, lib_inputs)
    lib_dev_ms = device_ms(torch.matmul, lib_inputs, None)

    # The function needs only the bank's non-zero support: each output is a
    # sum over the support of its column, so the bound counts 2 * rows * nnz
    # operations at the 3xTF32 rate (three TF32 products per f32-accurate
    # one) and nnz bank entries read once; the FP32-core bound and the dense
    # product are printed beside it.
    m_rows = BATCH * n_frames
    nnz = int(torch.count_nonzero(bank[:, :n_out]))
    nbytes = 4.0 * (xpad.numel() + nnz + m_rows * n_out)
    bound_ms, bound_by = roofline(2.0 * m_rows * nnz, nbytes, PEAK_TF32_FLOPS / 3)
    fp32_ms, _ = roofline(2.0 * m_rows * nnz, nbytes)
    plan_flops = kcqt._device_plan(bank, n_out)[0].flops(m_rows)
    dense_flops = 2.0 * m_rows * width * n_out
    print(f"[timing] cqt_project: {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f}, "
          f"torch.matmul on the unfolded frames {library_ms:.4f} (device {lib_dev_ms:.4f}; kernel "
          f"device time below it: {dev_ms < lib_dev_ms}) | {card_line()}")
    print(f"[timing] cqt_project: bank non-zero share {nnz / (width * n_out):.4f} ({nnz} of "
          f"{width * n_out}): {2.0 * m_rows * nnz / 1e9:.3f} GFLOP; bound {bound_ms:.4f} ms "
          f"({bound_by}; 3xTF32 at {PEAK_TF32_FLOPS / 3e12:.0f} TFLOP/s), FP32-core bound "
          f"{fp32_ms:.4f} ms; the tile plan computes {plan_flops / 1e9:.3f} GFLOP "
          f"({plan_flops / (2.0 * m_rows * nnz):.3f}x the non-zero count); the dense product "
          f"is {dense_flops / 1e9:.2f} GFLOP")
    return {
        "name": "cqt_project", "route": "cuda", "source": "sot_tpu_torch/csrc/cqt.cu",
        "replaces": "sot_tpu/ops/pallas/cqt.py:52",
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def synth_sample_counts(inputs, t: int, sr: int):
    """(every, prefix, kept): lane-samples per call, the mean over the
    timed ``inputs`` (controls first in each): all of them, those up to each
    lane's last sample below Nyquist, and those below it (the kernels' own
    keep test, env_f < the f32 Nyquist)."""
    nyquist = ksynth._scalars(sr)[0]
    counts = []
    for args in inputs:
        env_f = ksynth.synth_envelopes_plain(args[0], args[1], t, sr)[0]
        keep = env_f < nyquist  # [B, T, K]
        steps = torch.arange(1, t + 1, device=keep.device)[None, :, None]
        prefix = torch.where(keep, steps, 0).amax(1)  # [B, K]: samples up to the last kept
        counts.append((keep.numel(), int(prefix.sum()), int(keep.sum())))
    return tuple(statistics.fmean(c[i] for c in counts) for i in range(3))


def synth_bound(fp32_ops, fp64_ops, counts, bytes_moved: float):
    """issue_bound of the operations (every, prefix, kept) per lane-sample
    over the sample counts of synth_sample_counts."""
    return issue_bound(float(sum(o * n for o, n in zip(fp32_ops, counts))),
                       float(sum(o * n for o, n in zip(fp64_ops, counts))), bytes_moved)


def check_synth(cfg, dev, rng):
    sr, t = cfg.sample_rate, cfg.n_samples
    amps, freqs = synth_controls(rng, dev, sr)
    audio, env_f, env_a, phase = ksynth.synth_render(amps, freqs, t, sr, debug_envelopes=True)
    again = ksynth.synth_render(amps, freqs, t, sr)
    twice = ksynth.synth_render(amps, freqs, t, sr)
    ref_f, ref_a = ksynth.synth_envelopes_plain(amps, freqs, t, sr)
    ref_phase = ksynth.synth_phase_plain(ref_f, sr)
    cpu_f, cpu_a = ksynth.synth_envelopes_plain(amps.cpu(), freqs.cpu(), t, sr)
    ref = ksynth.synth_render_plain(amps, freqs, t, sr)
    # the plain terms summed in k order from +0, as the kernel sums them
    terms = ref_a * torch.sin(ref_phase)
    k_order = torch.zeros_like(audio)
    for k in range(terms.shape[-1]):
        k_order = k_order + terms[..., k]
    torch.cuda.synchronize()
    bit_equal = (torch.equal(env_f, ref_f) and torch.equal(env_a, ref_a)
                 and torch.equal(env_f.cpu(), cpu_f) and torch.equal(env_a.cpu(), cpu_a))
    phase_equal = torch.equal(phase, ref_phase)
    repeat_equal = torch.equal(again, twice) and torch.equal(again, audio)
    err = float((audio - ref).abs().max())
    corr = float(np.corrcoef(audio.cpu().numpy().ravel(), ref.cpu().numpy().ravel())[0, 1])
    print(f"[kernels] synth {tuple(amps.shape)} -> {tuple(audio.shape)}: envelopes "
          f"bit-equal {bit_equal} (card plain and CPU plain), phase bit-equal {phase_equal}, "
          f"two launches (and the debug launch) bit-equal {repeat_equal}, audio max|d| "
          f"{err:.3e} (limit 2e-2), corr {corr:.7f} (limit 0.9999); audio bit-equal to the "
          f"plain terms summed in k order on the card: {torch.equal(audio, k_order)} "
          f"(max|d| {float((audio - k_order).abs().max()):.3e})")
    require(bit_equal, "synth envelopes are not bit-equal to the plain version")
    require(phase_equal, "synth phase is not bit-equal to the plain version")
    require(repeat_equal, "two synth launches disagree")
    require(err <= 2e-2 and corr > 0.9999, "synth audio disagrees")
    hz_above = float((freqs >= sr / 2).float().mean())
    print(f"[kernels] synth: share of sinusoid-frames at/above Nyquist {hz_above:.3f}, "
          f"of sinusoid-samples {float((ref_f >= sr / 2).float().mean()):.3f}")

    inputs = [synth_controls(rng, dev, sr) + (t, sr) for _ in range(TIMING_INPUTS)]
    ms = median_ms(ksynth.synth_render, inputs)
    # the phase-totals launch and the forward launch
    dev_ms = device_ms(ksynth.synth_render, inputs, "synth_", 2)
    plain_ms = median_ms(ksynth.synth_render_plain, inputs)
    b, f, k = amps.shape
    counts = synth_sample_counts(inputs, t, sr)
    # inputs: controls, the lo/frac tables and the window; output: the audio
    bound_ms, bound_by, flop_ms = synth_bound(
        SYNTH_FP32_OPS, SYNTH_FP64_OPS, counts,
        4.0 * (2 * b * f * k + 2 * t + 2 * (t // f) + b * t))
    print(f"[timing] synth_render: {ms:.4f} ms (device {dev_ms:.4f}, both launches), plain "
          f"{plain_ms:.4f}, bound {bound_ms:.4f} ms ({bound_by}, issue rate, the work of the "
          f"timed inputs: {counts[2] / counts[0]:.4f} of the lane-samples below Nyquist, "
          f"{counts[1] / counts[0]:.4f} up to a lane's last one; at 67 TFLOP/s "
          f"{flop_ms:.4f}) | {card_line()}")
    return {
        "name": "synth_render", "route": "cuda", "source": "sot_tpu_torch/csrc/synth.cu",
        "replaces": "sot_tpu/ops/pallas/synth.py:140",
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_flop_ms": flop_ms,
        "library_ms": None,
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


# device busy ms of each profiled call, by what profile_device was told it is
BUSY_MS: dict = {}


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
    BUSY_MS[what] = busy / 1e3
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


def sot_rows_errors(g, dev, route):
    """The route's SOT kernels (the merge forward, and kernel 5 for ``ref``,
    kernel 7 for ``hybrid`` or kernel 8 for ``full``) on the clipped CDFs of
    real SOT rows (JAX's
    spectra: identical inputs, where the gradient convention must match
    exactly) against the JAX Pallas kernels' outputs (interpret mode, CPU):
    W's max|d| over the largest marginal term, the beta cotangent's
    max|d|/max, and the cotangent's bit-equal share."""
    alpha, beta, gaug = (torch.from_numpy(g[k]).to(dev)
                         for k in ("sot_alpha", "sot_beta", "sot_gaug"))
    rows = alpha.shape[0]
    w = kmerge.sot_w2_merge(alpha, beta, gaug).cpu().numpy()
    if route == "full":
        # kernel 8's dS/db against JAX's merge-gradient kernel, which sees the
        # columns without the last (shaved: its grid delta is 0, and so is the
        # port's last column)
        db = kmerge.coupling_grads(*complements(alpha, beta, gaug), False)[1].cpu().numpy()
        require(not np.any(db[:, -1]), "the coupling gradient's last column is not 0")
        db = db[:, :-1]
    else:
        db = route_grad_beta(alpha, beta, gaug, torch.full((rows,), 1.0 / rows, device=dev),
                             route).cpu().numpy()
    a, b, x2 = g["sot_alpha"], g["sot_beta"], g["sot_gaug"] ** 2
    marg = ((a - np.pad(a, ((0, 0), (1, 0)))[:, :-1]) @ x2
            + (b - np.pad(b, ((0, 0), (1, 0)))[:, :-1]) @ x2)
    return (float(np.abs(w - g["sot_w"]).max() / marg.max()), max_rel(db, g["sot_db"]),
            float(np.mean(db == g["sot_db"])))


def rank_golden_check(g, dev, phase):
    """Kernels 4, 5 and 8 on the golden's real rows against their plain
    versions: S per row within COUPLING_LIMIT, the beta cotangent equal
    (``refgrad_equal``), the coupling gradient within COUPLING_GRAD_LIMIT
    (``coupling_grads_case``)."""
    alpha, beta, gaug = (torch.from_numpy(g[k]).to(dev)
                         for k in ("sot_alpha", "sot_beta", "sot_gaug"))
    a, b, x = complements(alpha, beta, gaug)
    rel = coupling_rel(kmerge.coupling(a, b, x), kmerge.coupling_plain(a, b, x))
    print(f"[{phase}] merge coupling on the golden's rows against its plain version: per-row "
          f"rel err {rel:.3e} (limit {COUPLING_LIMIT})")
    require(rel <= COUPLING_LIMIT, f"{phase}: merge coupling disagrees on the golden's rows")
    rows = alpha.shape[0]
    refgrad_equal(f"{phase} golden", alpha, beta, gaug,
                  torch.full((rows,), 1.0 / rows, device=dev))
    coupling_grads_case(f"{phase} golden", a, b, x, False)


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


def leaf_readings(grads, g, limits):
    """{term: {flax leaf: (max|d|/max, cosine)}} against the golden's JAX
    gradients, and the [(term, leaf)] outside ``limits`` (GRAD_LIMITS-like,
    LEAF_COSINE-like)."""
    grad_limits, leaf_cosine = limits
    readings, misses = {}, []
    for tag in GRAD_TERMS:
        readings[tag] = {}
        for name, got in sorted(grads[tag].items()):
            ref = g[f"grad_{tag}/{name}"]
            require(got.shape == ref.shape and bool(np.isfinite(got).all()),
                    f"gradient {tag}/{name}: shape or non-finite")
            e, c = readings[tag][name] = (max_rel(got, ref), cosine(got, ref))
            if e > grad_limits[tag] or c < leaf_cosine[tag]:
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
            target_constant=fn.target_constant, kernels=fn.kernels)
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
    """The train-step kernels composed (synth forward and backward, merge
    coupling, the route's SOT backward) with cuFFT on the card, from the synth controls
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


def grad_controls(route):
    """(name, [(module, attribute)], replacement) of deliberately wrong
    gradients for the SOT route's kernels; a gate of the train-golden phase
    must reject each."""
    synth = synths_lib.synth_render
    on_synth = [(synths_lib, "synth_render")]
    controls = [
        ("synth d frequencies zeroed", on_synth,
         lambda a, f, t, sr: synth(a, f.detach(), t, sr)),
        ("synth d amplitudes zeroed", on_synth,
         lambda a, f, t, sr: synth(a.detach(), f, t, sr)),
        ("synth d frequencies 10% low", on_synth,
         lambda a, f, t, sr: synth(a, scaled_grad(f, 0.9), t, sr)),
    ]
    if route == "full":
        coupling_grads, conv_weight = kmerge.coupling_grads, kconv.conv1d_weight

        def low_db(a, b, x, alpha_grads=True):
            da, db = coupling_grads(a, b, x, alpha_grads)
            return da, 0.9 * db

        return controls + [
            ("kernel 8 coupling gradient 10% low",
             [(kmerge, "coupling_grads"), (wasserstein_lib, "coupling_grads")], low_db),
            ("kernel 11 conv weight gradient 10% low", [(kconv, "conv1d_weight")],
             lambda x, dy, k, dtype=torch.bfloat16: 0.9 * conv_weight(x, dy, k, dtype)),
        ]
    if route == "ref":
        sot = krefgrad.ref_grad_beta
        on_sot = [(krefgrad, "ref_grad_beta"), (wasserstein_lib, "ref_grad_beta")]
        return controls + [
            ("SOT beta gradient 10% low", on_sot,
             lambda al, be, g, w: 0.9 * sot(al, be, g, w)),
            ("SOT beta gradient with one-sided ties", on_sot, tie_free_grad_beta),
        ]
    plane_bwd = kplane.sot_plane_backward

    def low(al, be, g, p, w, alpha_grads):
        da, db = plane_bwd(al, be, g, p, w, alpha_grads)
        return da, 0.9 * db

    on_plane = [(kplane, "sot_plane_backward"), (wasserstein_lib, "sot_plane_backward")]
    return controls + [("kernel 7 beta cotangent 10% low", on_plane, low)]


def compare_devices(cfg, card, cpu, phase, route):
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
        print(f"[{phase}] card vs CPU (the port on both), {tag}: max|d|/max worst {worst} "
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
    print(f"[{phase}] card vs CPU: quantile cap differs on {np.count_nonzero(d)} of "
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
    print(f"[{phase}] card vs CPU: x_hat max|d|/max per clip max "
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
            db = route_grad_beta(alpha, beta, gaug, torch.full_like(alpha[:, 0], 1.0), route)
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
    print(f"[{phase}] card vs CPU, the SOT rows of the card's x_hat: the beta cotangent "
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
    print(f"[{phase}] card vs CPU: synth controls max|d|/max amplitudes "
          f"{max_rel(a_card, a_cpu):.3e}, frequencies {max_rel(f_card, f_cpu):.3e}; the plain "
          f"synth VJP on the CPU, one cotangent, on the card's controls against the CPU's: "
          f"d amplitudes {max_rel(da2, da):.3e}, d frequencies {max_rel(df2, df):.3e} of their "
          f"max; the synth backward kernel on the CPU's controls and cotangent against that "
          f"VJP: d amplitudes {max_rel(ka, da):.3e}, d frequencies {max_rel(kf, df):.3e}")


def route_bwd_name(route: str) -> str:
    return {"ref": "refgrad", "full": "coupling gradient, STFT frontend"}.get(
        route, "plane backward")


def train_golden_gates(g, dev, mod, x, composed, limits, route, encoder):
    """Every gate of the phase: {gate: (passed, readings)}."""
    err_w, err_db, share = sot_rows_errors(g, dev, route)
    _, grads, _, _ = loss_and_grads(mod, x)
    readings, misses = leaf_readings(grads, g, limits)
    err_a, err_f = composed()
    gates = {}
    if encoder is not None:
        err_e = encoder()
        gates["encoder kernels against the CPU"] = (err_e <= ENCODER_LIMIT,
                                                    f"parameter gradients {err_e:.3e}")
    return gates | {
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


def check_train_golden(cfg, dev, golden=GOLDEN_TRAIN, weights=GOLDEN,
                       limits=(GRAD_LIMITS, LEAF_COSINE), phase="train-golden", kernels="auto"):
    """The train step's gradient on ``dev`` against the JAX CPU golden and
    the port on the CPU (eval mode, the golden's 16 clips): the SOT route's
    kernels on JAX's rows, the loss and its two terms, the gradient of each
    term per parameter leaf within ``limits``, the composed kernels, under
    the conv gate the encoder's kernels; on the card, the readings against
    the port on the CPU; then every control must fail a gate. ``weights``:
    the npz holding the model's parameters; ``kernels``: the port's gates."""
    with np.load(golden) as z:
        g = {k: z[k] for k in z.files}
    route = wasserstein_lib.w2_route(int(g["sot_alpha"].shape[1]) - 1, kernels)
    print(f"[{phase}] {cfg.name}, {g['x'].shape[0]} clips, JAX gates {g['gates']}; the "
          f"port's SOT route {route!r}")
    mod = build_modules(cfg, device=dev, kernels=kernels)
    load_golden_weights(mod, weights)
    mod_cpu = build_modules(cfg, device="cpu", kernels=kernels)
    load_golden_weights(mod_cpu, weights)
    x_cpu = torch.from_numpy(g["x"])
    x = x_cpu.to(dev)

    err_w, err_db, share = sot_rows_errors(g, dev, route)
    print(f"[{phase}] SOT kernels on the CDFs of JAX's spectra, {g['sot_alpha'].shape[0]} "
          f"real rows x {g['sot_alpha'].shape[1]}: W max|d|/max(marginals) {err_w:.3e} (limit "
          f"{SOT_ROW_LIMITS[0]}); beta cotangent max|d|/max {err_db:.3e} (limit "
          f"{SOT_ROW_LIMITS[1]}), bit-equal share {share:.6f}")
    require(err_w <= SOT_ROW_LIMITS[0] and err_db <= SOT_ROW_LIMITS[1],
            "SOT kernels disagree with JAX on real rows")
    if dev.type == "cuda":
        rank_golden_check(g, dev, phase)
    if "route_u" in g:
        route_rows_check(g, dev, kernels, phase)

    losses, grads, dx, out = loss_and_grads(mod, x)
    readings, misses = leaf_readings(grads, g, limits)
    for tag, r in readings.items():
        ref_loss = float(g[f"loss_{tag}"])
        rel = abs(losses[tag] - ref_loss) / abs(ref_loss)
        worst = max(r, key=lambda k: r[k][0])
        least = min(r, key=lambda k: r[k][1])
        print(f"[{phase}] {tag}: loss port {losses[tag]:.8f} JAX {ref_loss:.8f} (rel "
              f"{rel:.3e}, limit 1e-4); per leaf max|d|/max (limit {limits[0][tag]}) worst "
              f"{worst} {r[worst][0]:.3e}, cosine (limit {limits[1][tag]}) least "
              f"{least} {r[least][1]:.6f}; per leaf (max|d|/max, 1 - cosine) "
              + ", ".join(f"{k} {e:.2e} {1.0 - c:.1e}" for k, (e, c) in r.items()))
        require(rel <= 1e-4, f"train-golden {tag} loss disagrees")
    require(not misses, f"train-golden gradients outside the per-leaf limits: {misses}")

    _, cpu_grads, cpu_dx, cpu_out = loss_and_grads(mod_cpu, x_cpu)
    if dev.type == "cuda":
        compare_devices(cfg, (mod, x, grads, dx, out), (mod_cpu, x_cpu, cpu_grads, cpu_dx,
                                                        cpu_out), phase, route)
    composed = composed_check(mod, mod_cpu, x_cpu, cpu_out)
    err_a, err_f = composed()
    print(f"[{phase}] composed kernels (synth, merge, {route_bwd_name(route)}, cuFFT) from "
          f"the CPU's synth controls against the same on the CPU: d amplitudes {err_a:.3e}, d "
          f"frequencies {err_f:.3e} of their max (limit {COMPOSED_LIMIT})")
    require(err_a <= COMPOSED_LIMIT and err_f <= COMPOSED_LIMIT,
            "the composed kernels disagree with the CPU")
    encoder = None
    if mod.kernels.conv:
        encoder = encoder_check(mod, mod_cpu, x_cpu)
        err = encoder()
        print(f"[{phase}] encoder (conv kernels 10 and 11, {mod.kernels.conv_dtype}) from the "
              f"CPU's CQT features and one fixed cotangent on its heads, against the same on "
              f"the CPU: parameter gradients max|d|/max {err:.3e} (limit {ENCODER_LIMIT}); per "
              f"leaf " + ", ".join(f"{k} {v:.2e}" for k, v in encoder(per_leaf=True).items()))
        require(err <= ENCODER_LIMIT, "the encoder's kernels disagree with the CPU")

    for name, targets, fn in grad_controls(route):
        with contextlib.ExitStack() as stack:
            for module, attr in targets:
                stack.enter_context(mock.patch.object(module, attr, fn))
            gates = train_golden_gates(g, dev, mod, x, composed, limits, route, encoder)
        rejected = [k for k, (ok, _) in gates.items() if not ok]
        print(f"[{phase}] control ({name}): rejected by {rejected}; "
              + "; ".join(f"{k}: {v}" for k, (_, v) in gates.items()))
        require(bool(rejected), f"{phase} control ({name}) passed every gate")
    if "cap_rows" not in g:
        return
    print(f"[{phase}] cap-rounding rows of the 64-clip batch on the CPU (JAX f32 vs "
          f"float64 CDF sums): {int(g['cap_rows_differ'])} of {int(g['cap_rows'])} differ, "
          f"{int(g['cap_rows_jump'])} by more than 1e-6 rel (largest "
          f"{float(g['cap_jump_max_rel']):.3e}); target CDF rows that JAX's prefix sum makes "
          f"step down: {int(g['cdf_rows_decreasing'])}")


def encoder_check(mod, mod_cpu, x_cpu):
    """The encoder's parameter gradients on the card against the CPU, from
    the CPU's CQT features of ``x_cpu`` and one fixed cotangent on its two
    heads, eval mode. Returns a function giving the largest max|d|/max over
    the leaves (or each leaf's, with per_leaf)."""
    with torch.no_grad():
        feats = mod_cpu.feature_extractor(x_cpu[:, :-1])
    feats = feats.reshape(-1, feats.shape[-1])
    rng = np.random.default_rng(11)

    def grads(m, f, cot=None):
        m.encoder.eval()
        z = m.encoder(f)
        if cot is None:
            cot = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
                   for k, v in z.items()}
        loss = sum(torch.sum(v * cot[k].to(v.device)) for k, v in z.items())
        names, params = zip(*m.encoder.named_parameters())
        return dict(zip(names, torch.autograd.grad(loss, params))), cot

    ref, cot = grads(mod_cpu, feats)
    feats_dev = feats.to(mod.device)

    def errors(per_leaf=False):
        got, _ = grads(mod, feats_dev, cot)
        errs = {k: max_rel(got[k], ref[k]) for k in ref}
        return errs if per_leaf else max(errs.values())

    return errors


def route_rows_check(g, dev, kernels, phase):
    """The SOT route end to end (CDFs, the quantile cap, the merge value and
    its gradient) on JAX's own normalised spectra: W and the v cotangent per
    row against the JAX package's, on the rows whose cap agrees to within
    about 2 ulps (the JAX package sums the CDFs in blocked f32, the port in
    float64; where that moves the cap to another CDF value, the gradient of
    the row moves with it: on the golden's rows by up to 0.92 of the max)."""
    u, v = (torch.from_numpy(g[k]).to(dev) for k in ("route_u", "route_v"))
    grid = torch.from_numpy(g["sot_gaug"][:-1]).to(dev)
    vt = v.clone().requires_grad_(True)
    w = wasserstein_lib.wasserstein_same_grid(grid, u, vt, p=2.0, limit_quantile_range=True,
                                              target_constant=True, kernels=kernels)
    (dv,) = torch.autograd.grad(torch.mean(w), vt)
    with torch.no_grad():
        cap = clipped_cdfs(grid, u, v, True)[0][:, -1].cpu().numpy()
    jump = np.abs(cap - g["route_cap"]) > 1e-7 * g["route_cap"]  # ~2 ulps
    row_err = (np.abs(dv.cpu().numpy() - g["route_dv"]).max(-1) / np.abs(g["route_dv"]).max())
    w_err = np.abs(w.detach().cpu().numpy() - g["route_w"]) / np.abs(g["route_w"]).max()
    print(f"[{phase}] the SOT route on JAX's {len(cap)} rows of normalised spectra: the cap "
          f"differs on {int(jump.sum())} rows {np.nonzero(jump)[0].tolist()}; on the other rows "
          f"W max|d|/max {w_err[~jump].max():.3e}, v cotangent max|d|/max {row_err[~jump].max():.3e} "
          f"(limits {ROUTE_ROW_LIMITS}); on the cap rows {np.round(row_err[jump], 4).tolist()}")
    require(w_err[~jump].max() <= ROUTE_ROW_LIMITS[0] and row_err[~jump].max()
            <= ROUTE_ROW_LIMITS[1], "the SOT route disagrees with JAX's on its rows")


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


def coupling_rel(got, ref) -> float:
    """Kernel 4's per-row relative error against its plain version."""
    scale = torch.clamp(ref.abs(), min=max(1e-12 * float(ref.abs().max()), 1e-30))
    return float(((got - ref).abs() / scale).max())


def check_merge(rows):
    """[kernels] and [timing] for kernel 4 on the real SOT rows ``rows`` (a
    list of (alpha, beta, gaug); the first checked, the rest timed): S per
    row within COUPLING_LIMIT of the plain version and the rows on the
    all-pairs path. Returns its JSON entry."""
    alpha, beta, gaug = rows[0]
    a, b, x = complements(alpha, beta, gaug)
    tag = f"[{a.shape[0]}, {a.shape[1]}]"
    got = kmerge.coupling(a, b, x)
    ref = kmerge.coupling_plain(a, b, x)
    torch.cuda.synchronize()
    rel = coupling_rel(got, ref)
    err = float((got - ref).abs().max())
    unsorted = int(kmerge.unsorted_rows(a, b).sum())
    print(f"[kernels] merge coupling a, b {tuple(a.shape)}, x {x.numel()} (real): per-row rel "
          f"err max {rel:.3e} (limit {COUPLING_LIMIT}), max|d| {err:.3e}; rows with S = 0: "
          f"{int((ref == 0).sum())}; rows on the all-pairs path {unsorted} of {a.shape[0]}")
    require(bool(torch.isfinite(got).all()) and rel <= COUPLING_LIMIT,
            "merge coupling kernel disagrees")

    inputs = [complements(*r) for r in rows[1:]]
    ms = median_ms(kmerge.coupling, inputs)
    dev_ms = device_ms(kmerge.coupling, inputs, "coupling_fwd_kernel")
    plain_ms = median_ms(kmerge.coupling_plain, inputs)
    nrows, m = a.shape
    # reads a, b and x once, writes S; the x prefix (m adds), per element of
    # each side the order test (a compare) and its term (mul, mul, add)
    flops = m + 2 * nrows * m * 4
    bound_ms, bound_by = roofline(flops, 4.0 * (2 * nrows * m + m + nrows))
    print(f"[timing] merge coupling {tag}: {ms:.4f} ms (device {dev_ms:.4f}), plain "
          f"{plain_ms:.4f}, bound {bound_ms:.4f} ({bound_by}) | {card_line()}")
    return {
        "name": "merge_coupling", "shape": tag, "route": "cuda",
        "source": "sot_tpu_torch/csrc/merge.cu", "replaces": "sot_tpu/ops/pallas/merge.py:221",
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def refgrad_equal(what, alpha, beta, gaug, wbar) -> float:
    """Kernel 5 against its plain version: equal under == (torch.equal),
    bit for bit wherever the result is not a zero; the zeros of the other
    sign counted. Returns max|d|."""
    got = krefgrad.ref_grad_beta(alpha, beta, gaug, wbar)
    ref = krefgrad.ref_grad_beta_plain(alpha, beta, gaug, wbar)
    torch.cuda.synchronize()
    zeros = ref == 0
    bits = torch.equal(got.view(torch.int32)[~zeros], ref.view(torch.int32)[~zeros])
    signs = int((torch.signbit(got) != torch.signbit(ref))[zeros].sum())
    equal = torch.equal(got, ref)
    print(f"[kernels] refgrad {what} {tuple(alpha.shape)}: equal {equal}, bit for bit where "
          f"not a zero {bits} (must be both); zeros {int(zeros.sum())}, of which {signs} of the "
          f"other sign")
    require(bool(torch.isfinite(got).all()) and equal and bits,
            f"refgrad kernel disagrees with its plain version on {what} rows")
    return float((got - ref).abs().max())


def closed_form_columns(beta):
    """[rows, n] bool: the columns of kernel 5 whose flags vne_j or
    vne_{j+1} are 1 (the others are zeros)."""
    vne = beta > torch.nn.functional.pad(beta, (1, 0))[:, :-1]
    return vne | torch.nn.functional.pad(vne[:, 1:], (0, 1))


def ranks_pair(al, be, ga, wb):
    """The ranks alone: torch.searchsorted of beta into alpha, left and right."""
    return torch.searchsorted(al, be, right=False), torch.searchsorted(al, be, right=True)


def check_refgrad(rows, entry=True):
    """[kernels] and [timing] for kernel 5 on the real SOT rows ``rows``:
    equal to the plain version (``refgrad_equal``; and within 2e-5 of its
    max), the share of queries tied with an alpha value and of columns that
    need the closed form, timed beside the searchsorted pair (information:
    the ranks alone). Returns its JSON entry, or None without ``entry``."""
    alpha, beta, gaug = rows[0]
    nrows, n = alpha.shape
    tag = f"[{nrows}, {n}]"
    wbar = torch.full((nrows,), 1.0 / nrows, device=alpha.device)  # the mean's cotangent
    err = refgrad_equal("real", alpha, beta, gaug, wbar)
    scale = float(krefgrad.ref_grad_beta_plain(alpha, beta, gaug, wbar).abs().max())
    kinks = float((torch.searchsorted(alpha, beta, right=True)
                   > torch.searchsorted(alpha, beta, right=False)).float().mean())
    needed = float(closed_form_columns(beta).sum())
    print(f"[kernels] refgrad alpha, beta {tag}: max|d|/max|ref| {err / scale:.3e} (limit "
          f"2e-5); share of queries tied with an alpha value (kinks) {kinks:.4f}; share of "
          f"columns that need the closed form (vne_j or vne_j+1) {needed / (nrows * n):.4f}")
    require(err <= 2e-5 * scale, "refgrad kernel disagrees")

    inputs = [(al, be, ga, wbar) for al, be, ga in rows[1:]]
    ms = median_ms(krefgrad.ref_grad_beta, inputs)
    dev_ms = device_ms(krefgrad.ref_grad_beta, inputs, "refgrad_kernel")
    plain_ms = median_ms(krefgrad.ref_grad_beta_plain, inputs)
    ss_ms, ss_dev = median_ms(ranks_pair, inputs), device_ms(ranks_pair, inputs, None)
    # reads alpha, beta, g and wbar once, writes the cotangent; per column
    # the two flags (two compares), per column that needs it the closed
    # form's ~45 operations
    flops = 2 * nrows * n + 45 * needed
    bound_ms, bound_by = roofline(flops, 4.0 * (2 * nrows * n + n + nrows + nrows * n))
    print(f"[timing] refgrad {tag}: {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f}, "
          f"bound {bound_ms:.4f} ({bound_by}); information only, the ranks alone (not the same "
          f"function): the pair torch.searchsorted(alpha, beta, right=False/True) {ss_ms:.4f} "
          f"ms (device {ss_dev:.4f}) | {card_line()}")
    if not entry:
        return None
    return {
        "name": "ref_grad_beta", "shape": tag, "route": "cuda",
        "source": "sot_tpu_torch/csrc/refgrad.cu",
        "replaces": "sot_tpu/ops/pallas/refgrad.py:274",
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def edge_sot_rows(kind: str):
    """(alpha, beta, g, wbar) float32: a few clipped augmented CDFs on a
    uniform grid that each hit one edge of kernels 4 and 5's walks."""
    rng = np.random.default_rng(len(kind))
    if kind == "n=1":
        alpha, beta = np.array([[1.0], [0.0], [0.5]]), np.array([[1.0], [0.0], [0.5]])
    elif kind == "n=2":
        alpha = np.array([[0.0, 1.0], [0.5, 1.0], [1.0, 1.0], [0.25, 0.75]])
        beta = np.array([[0.0, 1.0], [0.5, 1.0], [0.5, 0.5], [0.75, 0.75]])
    elif kind == "q=0, alpha_0=0":  # leading zeros on both sides
        alpha = np.concatenate([np.zeros((4, 9)), np.cumsum(rng.random((4, 24)), -1)], -1)
        beta = np.concatenate([np.zeros((4, 5)), np.cumsum(rng.random((4, 28)), -1)], -1)
        alpha /= alpha[:, -1:]
        beta /= beta[:, -1:]
    elif kind == "cap plateau":  # both reach the cap early
        alpha = np.minimum(np.cumsum(rng.random((4, 40)), -1), 6.0) / 6.0
        beta = np.minimum(np.cumsum(rng.random((4, 40)), -1), 4.0) / 6.0
        beta[:, -1] = 1.0
    elif kind == "beta = alpha":
        alpha = np.minimum(np.cumsum(rng.random((4, 33)) * (rng.random((4, 33)) < 0.5), -1),
                           3.0)
        alpha /= np.maximum(alpha[:, -1:], 1e-3)
        beta = alpha.copy()
    elif kind == "all nonempty":
        alpha = np.cumsum(rng.random((4, 50)) + 0.01, -1)
        beta = np.cumsum(rng.random((4, 50)) + 0.01, -1)
        alpha /= alpha[:, -1:]
        beta /= alpha[:, -1:] * 0.9
    elif kind == "all empty but the last":
        alpha = np.zeros((4, 30))
        alpha[:, -1] = 1.0
        beta = np.zeros((4, 30))
        beta[:2, -1] = 1.0
        beta[2:, -1] = 0.5
    else:
        raise ValueError(kind)
    g = np.linspace(0.0, 1.0, alpha.shape[1])
    wbar = rng.random(len(alpha)) + 0.5
    return tuple(np.ascontiguousarray(v, dtype=np.float32) for v in (alpha, beta, g, wbar))


EDGE_KINDS = ("n=1", "n=2", "q=0, alpha_0=0", "cap plateau", "beta = alpha", "all nonempty",
              "all empty but the last")


def rank_row_checks(dev, rng):
    """[kernels] for kernels 4, 5 and 8 on rows that are not the smoke's:
    kernel 4 on unsorted rows (the complements of sorted rows permuted on
    either side and both, so that they stay >= 0: the all-pairs path),
    stress rows and edge rows within COUPLING_LIMIT per row; kernel 5
    bit-equal on stress rows, edge rows and rows whose beta is not sorted
    (the per-query searches); kernel 8 bit for bit on its stress rows
    (``grad_stress_rows``) and on dyadic rows at m = 1, 2 and 8192."""
    def on(arrays):
        return [torch.from_numpy(np.ascontiguousarray(t)).to(dev) for t in arrays]

    def permuted(t):
        return torch.from_numpy(rng.permuted(t.cpu().numpy(), axis=-1)).to(dev)

    cases = []
    for n in (258, 1026):
        a, b, x = complements(*on(random_plane_rows(rng, BATCH, n)[:3]))
        for side in ("a", "b", "both"):
            cases.append((f"unsorted ({side}) n={n}",
                          (permuted(a) if side in ("a", "both") else a,
                           permuted(b) if side in ("b", "both") else b, x)))
        cases.append((f"stress n={n}", complements(*on(stress_plane_rows(BATCH * 16, n)[:3]))))
    cases += [(f"edge ({k})", complements(*on(edge_sot_rows(k)[:3])))
              for k in EDGE_KINDS if k != "n=1"]
    worst = 0.0
    for what, (a, b, x) in cases:
        got, ref = kmerge.coupling(a, b, x), kmerge.coupling_plain(a, b, x)
        torch.cuda.synchronize()
        rel = coupling_rel(got, ref)
        worst = max(worst, rel)
        require(bool(torch.isfinite(got).all()) and rel <= COUPLING_LIMIT,
                f"merge coupling kernel disagrees on {what} rows (per-row rel {rel:.3e})")
    print(f"[kernels] merge coupling on {len(cases)} row sets (" + ", ".join(w for w, _ in cases)
          + f"): per-row rel err max {worst:.3e} (limit {COUPLING_LIMIT})")
    for n in (258, 1026):
        refgrad_equal(f"stress n={n}", *on(stress_plane_rows(BATCH * 16, n)))
        al, be, g, w = random_plane_rows(rng, BATCH, n)
        refgrad_equal(f"beta unsorted n={n}", *on((al, rng.permuted(be, axis=-1), g, w)))
    for k in EDGE_KINDS:
        refgrad_equal(f"edge ({k})", *on(edge_sot_rows(k)))
    for k in GRAD_STRESS_KINDS:
        coupling_grads_case(f"stress ({k})", *on(grad_stress_rows(k, BATCH * 16, 1025)), True)
    for m in (1, 2, 8192):
        coupling_grads_case(f"edge (m={m})", *complements(*on(dyadic_plane_rows(
            rng, BATCH if m < 8192 else 8, m + 1)[:3])), True)


def rank_relaunch_check(shapes):
    """Kernels 4, 5 and 8 twice on the same real SOT rows of each loss shape:
    bit-equal (fixed summation orders, no atomics)."""
    for tag, rows in shapes.items():
        alpha, beta, gaug = rows[0]
        wbar = torch.full((alpha.shape[0],), 1.0 / alpha.shape[0], device=alpha.device)
        a, b, x = complements(alpha, beta, gaug)
        runs = [(kmerge.coupling(a, b, x), krefgrad.ref_grad_beta(alpha, beta, gaug, wbar),
                 *kmerge.coupling_grads(a, b, x, True)) for _ in range(2)]
        torch.cuda.synchronize()
        equal = [torch.equal(u.view(torch.int32), v.view(torch.int32)) for u, v in zip(*runs)]
        print(f"[kernels] merge coupling, refgrad and coupling gradient {tag} real rows, two "
              f"launches: S, dbeta, dS/da, dS/db bit-equal {equal}")
        require(all(equal), f"kernels 4, 5 and 8 differ between two launches at {tag}")


def dyadic_plane_rows(rng: np.random.Generator, rows: int, n: int):
    """(alpha, beta, g, wbar) as float32 numpy on which every product and
    sum of the plane kernels and their plain versions is exact in f32:
    clipped CDFs on multiples of 2^-6 up to a per-row cap, with empty
    intervals (zero steps), plateaus, a cap tail and ties between alpha and
    beta (every 7th row has beta = alpha); a sorted grid of multiples of
    2^-4 with repeats; row weights of multiples of 2^-1. A term is then a
    multiple of 2^-18 (forward, p <= 3) or 2^-13 (backward) of magnitude
    <= 1 or <= 2, and no sum needs more than 24 bits."""
    cap = rng.integers(16, 65, (rows, 1))
    zero_share = rng.uniform(0.5, 0.98, (rows, 1))

    def cdf():
        steps = np.where(rng.random((rows, n - 1)) < zero_share, 0,
                         rng.integers(1, 4, (rows, n - 1)))
        return np.concatenate([np.minimum(np.cumsum(steps, -1), cap), cap], -1)

    alpha, beta = cdf(), cdf()
    beta[::7] = alpha[::7]
    g = np.sort(rng.integers(0, 17, n)) / 16.0
    wbar = rng.integers(1, 5, rows) / 2.0
    return tuple(a.astype(np.float32) for a in (alpha / 64.0, beta / 64.0, g, wbar))


def random_plane_rows(rng: np.random.Generator, rows: int, n: int, sort: bool = True):
    """(alpha, beta, g, wbar): clipped CDFs of spectra-like random weights
    (zero bins, the estimate at another mass) on a uniform grid; with
    ``sort`` False, each row's CDFs are permuted (the kernels' full-scan
    path)."""
    u = rng.random((rows, n - 1)) ** 8
    v = rng.random((rows, n - 1)) ** 8
    u[:, ::7] = 0.0
    v[:, ::5] = 0.0
    u /= u.sum(-1, keepdims=True)
    v /= v.sum(-1, keepdims=True) / rng.uniform(0.7, 1.3, (rows, 1))
    grid = np.linspace(0.0, 1.0, n - 1, dtype=np.float32)
    alpha, beta, gaug = (t.numpy() for t in clipped_cdfs(
        *(torch.from_numpy(a.astype(np.float32)) for a in (grid, u, v)), True))
    if not sort:
        alpha, beta = (rng.permuted(a, axis=-1) for a in (alpha, beta))
    wbar = (rng.random(rows) + 0.5).astype(np.float32)
    return alpha, beta, gaug, wbar


def stress_plane_rows(rows: int, n: int, seed: int = 0):
    """(alpha, beta, g, wbar): rows cycling through four stress kinds on a
    uniform grid: beta a spike against a spread alpha (one column spans the
    whole other side), the mirror (one row does), beta = alpha (every cell
    with mu > 0 a tie) and alpha with a zero-mass stretch over its middle
    half (a run of empty intervals)."""
    rng = np.random.default_rng(seed)
    spread = np.cumsum(rng.random((rows, n)) + 0.05, -1)
    spread /= spread[:, -1:]
    spike = np.broadcast_to(np.where(np.arange(n) >= n // 2, 1.0, 0.0), (rows, n))
    flat = spread.copy()
    flat[:, n // 4: 3 * n // 4] = flat[:, n // 4: n // 4 + 1]
    kinds = [(spread, spike), (spike, spread), (spread, spread), (flat, spread)]
    alpha = np.stack([kinds[r % 4][0][r] for r in range(rows)])
    beta = np.stack([kinds[r % 4][1][r] for r in range(rows)])
    g = np.linspace(0.0, 1.0, n)
    wbar = rng.random(rows) + 0.5
    return tuple(a.astype(np.float32) for a in (alpha, beta, g, wbar))


GRAD_STRESS_KINDS = ("all zeros", "a = b", "one distinct value")


def grad_stress_rows(kind: str, rows: int, m: int, seed: int = 0):
    """(a, b, x) float32 numpy for kernel 8 on dyadic grid deltas (multiples
    of 2^-10, some 0): "all zeros" (every query ties every element), "a =
    b" (the complements of random sorted CDFs, b a copy of a) and "one
    distinct value" (a constant; b the same constant on even rows, above
    it on odd ones)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 4, m) / 1024.0).astype(np.float32)
    if kind == "all zeros":
        a = b = np.zeros((rows, m), np.float32)
    elif kind == "a = b":
        alpha = random_plane_rows(rng, rows, m + 1)[0]
        a = alpha[:, -1:] - alpha[:, :-1]
        b = a.copy()
    elif kind == "one distinct value":
        a = np.full((rows, m), 0.5, np.float32)
        b = np.where(np.arange(rows)[:, None] % 2 == 0, 0.5, 0.75) + np.zeros((1, m))
    else:
        raise ValueError(kind)
    return tuple(np.ascontiguousarray(t, dtype=np.float32) for t in (a, b, x))


def plane_outputs(alpha, beta, g, wbar, p, fwd, bwd):
    """(W, dalpha, dbeta with alpha_grads, dbeta without) of one pair of
    plane functions."""
    w = fwd(alpha, beta, g, p)
    da, db = bwd(alpha, beta, g, p, wbar, True)
    _, db_tc = bwd(alpha, beta, g, p, wbar, False)
    return w, da, db, db_tc


def check_plane_case(what, arrays, dev, p, exact):
    """Kernels 6 and 7 (both alpha_grads) against their plain versions on
    the card. exact: every output bit-equal; else the forward within
    PLANE_LIMITS[0] of each row's value and the cotangents within
    PLANE_LIMITS[1] of their max. Returns (max|d| of W, max|d| of the
    cotangents)."""
    alpha, beta, g, wbar = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
    got = plane_outputs(alpha, beta, g, wbar, p, kplane.sot_plane_forward,
                        kplane.sot_plane_backward)
    ref = plane_outputs(alpha, beta, g, wbar, p, kplane.sot_plane_forward_plain,
                        kplane.sot_plane_backward_plain)
    torch.cuda.synchronize()
    equal = [torch.equal(a, b) for a, b in zip(got, ref)]
    share = float(np.mean([float((a == b).float().mean()) for a, b in zip(got, ref)]))
    w_rel = float(((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1e-30)).max())
    d_rel = max(max_rel(a, b) for a, b in zip(got[1:], ref[1:]))
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    print(f"[kernels] plane {what} {tuple(alpha.shape)} p={p:g}: W per-row rel {w_rel:.3e}, "
          f"cotangents max|d|/max {d_rel:.3e} (alpha_grads both ways); bit-equal: W, dalpha, "
          f"dbeta, dbeta (target constant) {equal}, share {share:.6f}"
          + (" (must be bit-equal)" if exact else f" (limits {PLANE_LIMITS})"))
    if exact:
        require(finite and all(equal), f"plane kernels are not bit-equal on {what} rows")
    else:
        require(finite and w_rel <= PLANE_LIMITS[0] and d_rel <= PLANE_LIMITS[1],
                f"plane kernels disagree on {what} rows")
    return (float((got[0] - ref[0]).abs().max()),
            max(float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:])))


def route_grad_beta(alpha, beta, gaug, wbar, route):
    """The beta cotangent of the SOT route's backward: kernel 5 for ``ref``,
    kernel 7 (target constant) for ``hybrid`` and ``plane``; for ``full``,
    kernel 8's coupling gradient dS/db times the row weights (zero on the
    tail lane). Looked up at call time, so that a control's patch reaches
    it."""
    if route == "ref":
        return krefgrad.ref_grad_beta(alpha, beta, gaug, wbar)
    if route == "full":
        db = kmerge.coupling_grads(*complements(alpha, beta, gaug), False)[1]
        return wbar[:, None] * torch.nn.functional.pad(db, (0, 1))
    return kplane.sot_plane_backward(alpha, beta, gaug, 2.0, wbar, False)[1]


def plane_walk_stats(alpha, beta):
    """What kernels 6 and 7 do on these rows: the cells with mu > 0 (the
    function's work; on sorted rows they lie on the merge path, on the rows
    that are not sorted counted densely), the rows on the full-scan path,
    the walk's positions (a row's nonempty intervals of alpha and beta, plus
    one: their sum, median and max over the rows),
    the most mu > 0 cells one thread's slice of them holds and how far that
    lies above its row's even share, ceil(cells / THREADS_PER_ROW)."""
    rows, n = alpha.shape
    full = kplane.full_scan_rows(alpha, beta)
    prev = [torch.nn.functional.pad(x, (1, 0))[:, :-1] for x in (alpha, beta)]
    ne_a, ne_b = alpha > prev[0], beta > prev[1]
    i, j = kplane.staircase(alpha, beta)
    inside = (i < n) & (j < n)
    ic, jc = i.clamp(max=n - 1), j.clamp(max=n - 1)
    a, c = alpha.gather(1, ic), prev[0].gather(1, ic)
    b, d = beta.gather(1, jc), prev[1].gather(1, jc)
    mu = inside & (torch.minimum(a, b) > torch.maximum(c, d)) & ~full[:, None]
    # a cell's place in the walk: the nonempty rows and columns before it
    rank_a = torch.cumsum(ne_a.long(), 1) - ne_a.long()
    rank_b = torch.cumsum(ne_b.long(), 1) - ne_b.long()
    pos = rank_a.gather(1, ic) + rank_b.gather(1, jc)
    npos = ne_a.sum(1) + ne_b.sum(1) + 1
    tpr = kplane.THREADS_PER_ROW
    length = (npos + tpr - 1) // tpr
    per_slice = torch.zeros((rows, tpr), dtype=torch.long, device=alpha.device)
    per_slice.scatter_add_(1, torch.where(mu, pos // length[:, None], 0), mu.long())
    cells = float(mu.sum())
    for r in torch.nonzero(full).flatten().tolist():
        m = (torch.minimum(alpha[r][:, None], beta[r][None, :])
             > torch.maximum(prev[0][r][:, None], prev[1][r][None, :]))
        cells += float(m.sum())
    even = (mu.sum(1) + tpr - 1) // tpr  # each row's even share of its cells
    excess = torch.where(full, 0, per_slice.max(1).values - even)
    walked = npos[~full].double()
    return {"cells": cells, "full_rows": int(full.sum()),
            "positions": float(walked.sum()),
            "positions_median": float(walked.median()) if len(walked) else 0.0,
            "positions_max": float(walked.max()) if len(walked) else 0.0,
            "slice_max": int(per_slice.max()), "slice_excess": int(excess.max())}


def plane_bound(alpha, beta, stats, backward: bool, alpha_grads: bool = False):
    """(bound_ms, bound_by) of kernel 6 or 7 on these inputs: each input read
    once, each output written once; per cell with mu > 0 (``stats``, the
    function's work) 8 operations forward (min, max, sub, compare, grid
    sub, square, mul, add) or 14 backward for dbeta (the mask, the grid
    term, the weight, the tie weights, two products, two differences, two
    adds), 6 more for dalpha."""
    rows, n = alpha.shape
    cells = stats["cells"]
    if not backward:
        return roofline(8 * cells, 4.0 * (2 * rows * n + n + rows))
    flops = 14 * cells + (6 * cells if alpha_grads else 0)
    out = rows * n * (2 if alpha_grads else 1)
    return roofline(flops, 4.0 * (2 * rows * n + n + rows + out))


def plane_kernel_checks(dev, rng, golden_512):
    """[kernels] for kernels 6 and 7: dyadic rows bit for bit at both loss
    shapes, the golden's real SOT-512 rows, random sorted rows at
    [1024, 1026] and unsorted rows, p = 2 and 3; then on the golden's rows,
    kernel 7's beta cotangent against kernel 5's and against JAX's
    _pallas_bwd, and the W of kernels 4 and 6 against JAX's. Returns the
    largest max|d| of kernel 6 and of kernel 7 against their plain versions
    on the rows that are not dyadic."""
    for n in (258, 1026):
        for p in (2.0, 3.0):
            check_plane_case("dyadic", dyadic_plane_rows(rng, BATCH * 16, n), dev, p, True)
    a, b, g = (golden_512[k] for k in ("sot_alpha", "sot_beta", "sot_gaug"))
    golden_rows = (a, b, g, (rng.random(len(a)) + 0.5).astype(np.float32))
    errs = []
    for p in (2.0, 3.0):
        errs.append(check_plane_case("SOT-512 golden (real)", golden_rows, dev, p, False))
        errs.append(check_plane_case("random sorted", random_plane_rows(rng, BATCH * 16, 1026),
                                     dev, p, False))
    errs.append(check_plane_case("unsorted", random_plane_rows(rng, BATCH, 258, sort=False),
                                 dev, 2.0, False))
    for n in (258, 1026):
        errs.append(check_plane_case("stress", stress_plane_rows(BATCH * 16, n), dev, 2.0, False))

    alpha, beta, gaug = (torch.from_numpy(golden_512[k]).to(dev)
                         for k in ("sot_alpha", "sot_beta", "sot_gaug"))
    rows = alpha.shape[0]
    wbar = torch.full((rows,), 1.0 / rows, device=dev)
    db7 = route_grad_beta(alpha, beta, gaug, wbar, "hybrid")
    db5 = route_grad_beta(alpha, beta, gaug, wbar, "ref")
    e75, e7j = max_rel(db7, db5), max_rel(db7, golden_512["sot_db"])
    x2 = golden_512["sot_gaug"] ** 2
    marg = float(((a - np.pad(a, ((0, 0), (1, 0)))[:, :-1]) @ x2
                  + (b - np.pad(b, ((0, 0), (1, 0)))[:, :-1]) @ x2).max())
    w4 = kmerge.sot_w2_merge(alpha, beta, gaug).cpu().numpy()
    w6 = kplane.sot_plane_forward(alpha, beta, gaug, 2.0).cpu().numpy()
    e4, e6 = (float(np.abs(w - golden_512["sot_w"]).max()) / marg for w in (w4, w6))
    print(f"[kernels] SOT-512 golden rows {tuple(alpha.shape)}: kernel 7 beta cotangent against "
          f"kernel 5 {e75:.3e} and against JAX _pallas_bwd {e7j:.3e} of the max (limit "
          f"{SOT_ROW_LIMITS[1]}; bit-equal shares {float((db7 == db5).float().mean()):.6f}, "
          f"{float(np.mean(db7.cpu().numpy() == golden_512['sot_db'])):.6f}); W of kernels 4 "
          f"and 6 against JAX's merge W: {e4:.3e}, {e6:.3e} of the marginals (limit "
          f"{SOT_ROW_LIMITS[0]})")
    require(e75 <= SOT_ROW_LIMITS[1] and e7j <= SOT_ROW_LIMITS[1],
            "kernel 7 disagrees with kernel 5 or JAX on real rows")
    require(e4 <= SOT_ROW_LIMITS[0] and e6 <= SOT_ROW_LIMITS[0],
            "kernels 4 and 6 disagree with JAX's W on real rows")
    return max(e[0] for e in errs), max(e[1] for e in errs)


def plane_relaunch_check(shapes):
    """Kernels 6 and 7 (both alpha_grads) twice on the same real SOT rows of
    each loss shape: every output bit-equal (fixed summation orders, no
    atomics)."""
    for tag, rows in shapes.items():
        alpha, beta, gaug = rows[0]
        wbar = torch.full((alpha.shape[0],), 1.0 / alpha.shape[0], device=alpha.device)
        runs = [plane_outputs(alpha, beta, gaug, wbar, 2.0, kplane.sot_plane_forward,
                              kplane.sot_plane_backward) for _ in range(2)]
        torch.cuda.synchronize()
        equal = [torch.equal(a, b) for a, b in zip(*runs)]
        print(f"[kernels] plane {tag} real rows, two launches: W, dalpha, dbeta, dbeta (target "
              f"constant) bit-equal {equal}")
        require(all(equal), f"kernels 6 and 7 differ between two launches at {tag}")


def plane_timings(shapes):
    """[timing] of kernels 6 and 7 at both loss shapes on the real SOT rows
    (``shapes``: tag -> list of (alpha, beta, gaug)), with what the walk did
    on them, and of kernels 4 and 5 at [1024, 258]; the A/B of the
    ``hybrid`` backward (kernel 7) against ``ref``'s (kernel 5), in turns.
    Returns the JSON entries of kernels 6 and 7 at each shape."""
    def wbar_of(al):
        return torch.full((al.shape[0],), 1.0 / al.shape[0], device=al.device)

    def fwd6(al, be, ga, wb):
        return kplane.sot_plane_forward(al, be, ga, 2.0)

    def bwd7(al, be, ga, wb):
        return kplane.sot_plane_backward(al, be, ga, 2.0, wb, False)

    def plain6(al, be, ga, wb):
        return kplane.sot_plane_forward_plain(al, be, ga, 2.0)

    def plain7(al, be, ga, wb):
        return kplane.sot_plane_backward_plain(al, be, ga, 2.0, wb, False)

    def fwd4(al, be, ga, wb):
        return kmerge.sot_w2_merge(al, be, ga)

    def bwd5(al, be, ga, wb):
        return krefgrad.ref_grad_beta(al, be, ga, wb)

    card = card_line()
    entries = []
    for tag, rows in shapes.items():
        inputs = [(al, be, ga, wbar_of(al)) for al, be, ga in rows]
        alpha, beta = inputs[0][:2]
        ms = {"6": median_ms(fwd6, inputs), "7": median_ms(bwd7, inputs),
              "6 plain": median_ms(plain6, inputs), "7 plain": median_ms(plain7, inputs),
              "6 device": device_ms(fwd6, inputs, "plane_fwd_kernel"),
              "7 device": device_ms(bwd7, inputs, "plane_bwd_kernel")}
        stats = plane_walk_stats(alpha, beta)
        b6, b7 = plane_bound(alpha, beta, stats, False), plane_bound(alpha, beta, stats, True)
        nrows, n = alpha.shape
        print(f"[timing] plane {tag}: kernel 6 {ms['6']:.4f} ms (device {ms['6 device']:.4f}, "
              f"plain {ms['6 plain']:.4f}, bound {b6[0]:.4f} {b6[1]}), kernel 7 {ms['7']:.4f} ms "
              f"(device {ms['7 device']:.4f}, plain {ms['7 plain']:.4f}, bound {b7[0]:.4f} "
              f"{b7[1]}); mu > 0 cells per row {stats['cells'] / nrows:.1f} of {n * n}, rows on "
              f"the full-scan path {stats['full_rows']} of {nrows}, walk positions per row "
              f"{stats['positions'] / max(1, nrows - stats['full_rows']):.1f} (median "
              f"{stats['positions_median']:.0f}, max {stats['positions_max']:.0f}), slice balance: at "
              f"most {stats['slice_max']} mu > 0 cells in one thread's slice, at most "
              f"{stats['slice_excess']} above its row's even share | {card}")
        for name, kernel, line, bound in (("sot_plane_forward", "6", 91, b6),
                                          ("sot_plane_backward", "7", 137, b7)):
            entries.append({
                "name": name, "shape": tag, "route": "cuda",
                "source": "sot_tpu_torch/csrc/plane.cu",
                "replaces": f"sot_tpu/ops/pallas/sot.py:{line}", "max_abs_err": None,
                "ms": ms[kernel], "device_ms": ms[f"{kernel} device"],
                "plain_ms": ms[f"{kernel} plain"], "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None})
        if tag == "[1024, 258]":
            # parent-free A/B inside one call: 5, 7, 7, 5 and the forward 4
            ab = [median_ms(bwd5, inputs), median_ms(bwd7, inputs), median_ms(bwd7, inputs),
                  median_ms(bwd5, inputs)]
            ms4 = median_ms(fwd4, inputs)
            k5, k7 = (ab[0] + ab[3]) / 2, (ab[1] + ab[2]) / 2
            dev = [device_ms(bwd5, inputs, "refgrad_kernel"),
                   device_ms(bwd7, inputs, "plane_bwd_kernel"),
                   device_ms(bwd7, inputs, "plane_bwd_kernel"),
                   device_ms(bwd5, inputs, "refgrad_kernel")]
            dev4 = device_ms(fwd4, inputs, "coupling_fwd_kernel")
            print(f"[timing] A/B at [1024, 258], turns 5, 7, 7, 5 (CUDA events per call): "
                  f"kernel 5 (ref backward) {ab[0]:.4f} / {ab[3]:.4f} ms, kernel 7 (hybrid "
                  f"backward) {ab[1]:.4f} / {ab[2]:.4f} ms; the merge forward both routes share "
                  f"(kernel 4 with its PyTorch terms) {ms4:.4f} ms; route totals ref "
                  f"{ms4 + k5:.4f} ms, hybrid {ms4 + k7:.4f} ms (hybrid - ref {k7 - k5:+.4f} ms, "
                  f"{100.0 * (k7 - k5) / (ms4 + k5):+.1f}%) | {card}")
            print(f"[timing] A/B at [1024, 258], device time per kernel (profiler), turns 5, 7, "
                  f"7, 5: kernel 5 {dev[0]:.4f} / {dev[3]:.4f} ms, kernel 7 {dev[1]:.4f} / "
                  f"{dev[2]:.4f} ms, kernel 4 {dev4:.4f} ms | {card}")
    return entries


def build_parent(parent_src: str, name: str, ours):
    """The library built from ``parent_src`` (another csrc/<name>.cu with the
    same C interface, e.g. an earlier commit's; the headers it includes are
    looked for beside it first), its functions typed as this checkout's
    bound library ``ours``."""
    import ctypes
    src = os.path.abspath(parent_src)
    tag = hashlib.sha256(src.encode()).hexdigest()[:8]  # one library per parent source
    lib_path = os.path.join(str(_build.BUILD_DIR), f"lib{name}_ab_parent_{tag}.so")
    out = subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.COMMON_FLAGS,
                          "-I", str(_build.CSRC), "-o", lib_path, src],
                         capture_output=True, text=True, timeout=600)
    require(out.returncode == 0,
            f"the parent's {name}.cu did not build:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(lib_path)
    for fn in ("sot_plane_forward_f32", "sot_plane_backward_f32", "coupling_forward_f32",
               "coupling_grads_f32", "refgrad_beta_f32"):
        if hasattr(ours, fn):
            getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
    return lib


def plane_ab(parent_src: str, shapes) -> None:
    """[timing] kernels 6 and 7 built from ``parent_src`` (another
    plane.cu with the same C interface, e.g. an earlier commit's) against
    this checkout's, device ms in turns old, new, new, old on the real SOT
    rows of each shape; the outputs of the two compared first (W and the
    target-constant dbeta within PLANE_LIMITS)."""
    old = build_parent(parent_src, "plane", kplane._bind())

    def old6(al, be, ga, wb):
        w = torch.empty((al.shape[0],), dtype=torch.float32, device=al.device)
        _build.check(old.sot_plane_forward_f32(
            al.data_ptr(), be.data_ptr(), ga.data_ptr(), 2.0, w.data_ptr(), *al.shape,
            torch.cuda.current_stream().cuda_stream), "parent sot_plane_forward_f32")
        return w

    def old7(al, be, ga, wb):
        db = torch.empty_like(be)
        _build.check(old.sot_plane_backward_f32(
            al.data_ptr(), be.data_ptr(), ga.data_ptr(), wb.data_ptr(), 2.0, None, db.data_ptr(),
            *al.shape, torch.cuda.current_stream().cuda_stream), "parent sot_plane_backward_f32")
        return db

    def new6(al, be, ga, wb):
        return kplane.sot_plane_forward(al, be, ga, 2.0)

    def new7(al, be, ga, wb):
        return kplane.sot_plane_backward(al, be, ga, 2.0, wb, False)[1]

    card = card_line()
    for tag, rows in shapes.items():
        inputs = [(al, be, ga, torch.full((al.shape[0],), 1.0 / al.shape[0], device=al.device))
                  for al, be, ga in rows]
        w_old, w_new = old6(*inputs[0]), new6(*inputs[0])
        d_old, d_new = old7(*inputs[0]), new7(*inputs[0])
        torch.cuda.synchronize()
        w_rel = float(((w_new - w_old).abs() / w_old.abs().clamp(min=1e-30)).max())
        d_rel = max_rel(d_new, d_old)
        require(w_rel <= PLANE_LIMITS[0] and d_rel <= PLANE_LIMITS[1],
                f"the parent's plane kernels disagree with this checkout's at {tag}")
        equal = [torch.equal(w_new, w_old), torch.equal(d_new, d_old)]
        for kernel, pair in (("6", (old6, new6)), ("7", (old7, new7))):
            name = f"plane_{'fwd' if kernel == '6' else 'bwd'}_kernel"
            turns = [device_ms(f, inputs, name) for f in (pair[0], pair[1], pair[1], pair[0])]
            print(f"[timing] A/B plane {tag} kernel {kernel}{' (target constant)' if kernel == '7' else ''}, device ms "
                  f"in turns old, new, new, old: {', '.join(f'{t:.4f}' for t in turns)}; old / "
                  f"new {(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x (outputs: W rel "
                  f"{w_rel:.3e}, dbeta {d_rel:.3e}, bit-equal {equal}) | {card}")


def ulps(got, ref) -> int:
    """The most units in the last place between two f32 tensors of one sign."""
    diff = got.contiguous().view(torch.int32).long() - ref.contiguous().view(torch.int32).long()
    return int(diff.abs().max())


def rank_ab(parent_src: str, shapes) -> None:
    """[timing] kernels 4 and 8 (parent merge.cu) or kernel 5 (parent
    refgrad.cu) built from ``parent_src`` against this checkout's, device
    ms in turns old, new, new, old on the real SOT rows of each loss shape;
    the outputs of the two compared first: kernel 5 equal (torch.equal),
    kernel 4 within COUPLING_LIMIT per row, kernel 8 within
    COUPLING_GRAD_LIMIT (``grad_ab``), the most ulps between them
    printed."""
    name = os.path.basename(parent_src)[:-len(".cu")]
    old = build_parent(parent_src, name, (kmerge if name == "merge" else krefgrad)._bind())
    stream = torch.cuda.current_stream

    def old4(a, b, x):
        out = torch.empty((a.shape[0],), dtype=torch.float32, device=a.device)
        _build.check(old.coupling_forward_f32(a.data_ptr(), b.data_ptr(), x.data_ptr(),
                                              out.data_ptr(), *a.shape, stream().cuda_stream),
                     "parent coupling_forward_f32")
        return out

    def old5(al, be, ga, wb):
        db = torch.empty_like(be)
        _build.check(old.refgrad_beta_f32(al.data_ptr(), be.data_ptr(), ga.data_ptr(),
                                          wb.data_ptr(), db.data_ptr(), *al.shape,
                                          stream().cuda_stream), "parent refgrad_beta_f32")
        return db

    card = card_line()
    for tag, rows in shapes.items():
        if name == "merge":
            inputs = [complements(*r) for r in rows]
            tag = f"[{inputs[0][0].shape[0]}, {inputs[0][0].shape[1]}]"
            pair, kernel, label = (old4, kmerge.coupling), "coupling_fwd_kernel", "kernel 4"
        else:
            inputs = [r + (torch.full((r[0].shape[0],), 1.0 / r[0].shape[0],
                                      device=r[0].device),) for r in rows]
            pair, kernel, label = (old5, krefgrad.ref_grad_beta), "refgrad_kernel", "kernel 5"
        got_old, got_new = pair[0](*inputs[0]), pair[1](*inputs[0])
        torch.cuda.synchronize()
        if name == "merge":
            rel = coupling_rel(got_new, got_old)
            outputs = (f"S per-row rel {rel:.3e} (limit {COUPLING_LIMIT}), at most "
                       f"{ulps(got_new, got_old)} ulps apart, bit-equal rows "
                       f"{int((got_new == got_old).sum())} of {got_old.numel()}")
            require(rel <= COUPLING_LIMIT, f"the parent's kernel 4 disagrees at {tag}")
        else:
            equal = torch.equal(got_new, got_old)
            outputs = f"dbeta equal {equal} (must be)"
            require(equal, f"the parent's kernel 5 is not equal to this one at {tag}")
        turns = [device_ms(f, inputs, kernel) for f in (pair[0], pair[1], pair[1], pair[0])]
        print(f"[timing] A/B {name}.cu {tag} {label}, device ms in turns old, new, new, old: "
              f"{', '.join(f'{t:.4f}' for t in turns)}; old / new "
              f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x (outputs: {outputs}) | {card}")
        if name == "merge":
            grad_ab(old, inputs, tag, card)


def grad_ab(old, inputs, tag, card) -> None:
    """[timing] kernel 8 from the parent's merge.cu against this
    checkout's on the real SOT rows ``inputs`` ((a, b, x) of each batch),
    db only as training calls it: the outputs first (equal, or within
    COUPLING_GRAD_LIMIT with the most ulps between them printed), then
    device ms in turns old, new, new, old."""
    def old8(a, b, x):
        db = torch.empty_like(b)
        _build.check(old.coupling_grads_f32(a.data_ptr(), b.data_ptr(), x.data_ptr(), None,
                                            db.data_ptr(), *a.shape,
                                            torch.cuda.current_stream().cuda_stream),
                     "parent coupling_grads_f32")
        return db

    def new8(a, b, x):
        return kmerge.coupling_grads(a, b, x, False)[1]

    got_old, got_new = old8(*inputs[0]), new8(*inputs[0])
    torch.cuda.synchronize()
    rel = max_rel(got_new, got_old)
    bits = torch.equal(got_new.view(torch.int32), got_old.view(torch.int32))
    require(rel <= COUPLING_GRAD_LIMIT, f"the parent's kernel 8 disagrees at {tag}")
    turns = [device_ms(f, inputs, "coupling_grad_kernel") for f in (old8, new8, new8, old8)]
    print(f"[timing] A/B merge.cu {tag} kernel 8 (db only), device ms in turns old, new, new, "
          f"old: {', '.join(f'{t:.4f}' for t in turns)}; old / new "
          f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x (outputs: dS/db max|d|/max "
          f"{rel:.3e} (limit {COUPLING_GRAD_LIMIT}), bit for bit {bits}, at most "
          f"{ulps(got_new, got_old)} ulps apart) | {card}")


def plain_synth_vjp(amps, freqs, dout, t, sr):
    a = amps.detach().requires_grad_(True)
    f = freqs.detach().requires_grad_(True)
    return torch.autograd.grad(ksynth.synth_render_plain(a, f, t, sr), (a, f), dout)


def synth_taps64(n_frames: int, t: int, dev: torch.device):
    """The transposed taps as float64 [T, F] matrices: d_freqs = M_f^T
    d_env_f (bilinear: 1 - frac to lo, frac to lo + 1) and d_amps = M_a^T
    d_env_a (window: w[hop + r] to frame j, w[r] to j + 1, the endpoint
    frame folded into F - 1)."""
    lo, frac, window = (x.cpu().numpy() for x in ksynth._tables(n_frames, t, dev)[:3])
    hop, rows = t // n_frames, np.arange(t)
    m_f, m_a = np.zeros((t, n_frames)), np.zeros((t, n_frames))
    np.add.at(m_f, (rows, lo), 1.0 - frac.astype(np.float64))
    np.add.at(m_f, (rows, lo + 1), frac.astype(np.float64))
    j, r = rows // hop, rows % hop
    np.add.at(m_a, (rows, j), window[hop + r].astype(np.float64))
    np.add.at(m_a, (rows, np.minimum(j + 1, n_frames - 1)), window[r].astype(np.float64))
    return torch.from_numpy(m_f).to(dev), torch.from_numpy(m_a).to(dev)


def synth_vjp64(amps, freqs, dout, t, sr):
    """The synth's VJP in float64 from the plain version's f32 envelopes and
    phase (the inputs the kernel and autograd share): (d amplitudes,
    d frequencies), [B, F, K]."""
    env_f, env_a = ksynth.synth_envelopes_plain(amps, freqs, t, sr)
    phase = ksynth.synth_phase_plain(env_f, sr).double()
    nyquist, omega_scale = ksynth._scalars(sr)
    g = dout.double()[:, :, None]
    d_env_a = torch.where(env_f < nyquist, g * torch.sin(phase), 0.0)
    d_phase = g * env_a.double() * torch.cos(phase)
    d_env_f = d_phase.flip(1).cumsum(1).flip(1) * omega_scale
    m_f, m_a = synth_taps64(amps.shape[1], t, amps.device)
    return (torch.einsum("tj,btk->bjk", m_a, d_env_a),
            torch.einsum("tj,btk->bjk", m_f, d_env_f))


def check_synth_backward(cfg, dev, rng):
    sr, t = cfg.sample_rate, cfg.n_samples
    amps, freqs = synth_controls(rng, dev, sr)
    dout = torch.from_numpy(rng.standard_normal((BATCH, t)).astype(np.float32)).to(dev)
    d_amps, d_freqs = ksynth.synth_backward(amps, freqs, dout, t, sr)
    again = ksynth.synth_backward(amps, freqs, dout, t, sr)
    ref_a, ref_f = plain_synth_vjp(amps, freqs, dout, t, sr)
    ref64_a, ref64_f = synth_vjp64(amps, freqs, dout, t, sr)
    torch.cuda.synchronize()
    rel_a = float((d_amps - ref_a).abs().max() / ref_a.abs().max())
    rel_f = float((d_freqs - ref_f).abs().max() / ref_f.abs().max())
    repeat_equal = torch.equal(d_amps, again[0]) and torch.equal(d_freqs, again[1])
    e64 = {name: (f64_rel(got, r64), f64_rel(plain, r64)) for name, got, plain, r64 in (
        ("d amplitudes", d_amps, ref_a, ref64_a), ("d frequencies", d_freqs, ref_f, ref64_f))}
    print(f"[kernels] synth backward {tuple(amps.shape)} from dout {tuple(dout.shape)}: "
          f"d amplitudes max|d|/max {rel_a:.3e} (limit 1e-4), d frequencies max|d|/max "
          f"{rel_f:.3e} (limit 1e-3); two launches bit-equal {repeat_equal}; against float64 "
          + ", ".join(f"{n} kernel {k:.3e} vs plain f32 {p:.3e} (limit 2x)"
                      for n, (k, p) in e64.items()))
    require(bool(torch.isfinite(d_amps).all() and torch.isfinite(d_freqs).all())
            and rel_a <= 1e-4 and rel_f <= 1e-3, "synth backward kernel disagrees")
    require(repeat_equal, "two synth backward launches disagree")
    require(all(k <= 2.0 * p for k, p in e64.values()),
            "synth backward: error against float64 above 2x the plain version's")

    inputs = []
    for _ in range(TIMING_INPUTS):
        a, f = synth_controls(rng, dev, sr)
        g = torch.from_numpy(rng.standard_normal((BATCH, t)).astype(np.float32)).to(dev)
        inputs.append((a, f, g, t, sr))
    ms = median_ms(ksynth.synth_backward, inputs)
    dev_ms = device_ms(ksynth.synth_backward, inputs, "synth_bwd_kernel")
    plain_ms = median_ms(plain_synth_vjp, inputs)
    b, nf, k = amps.shape
    counts = synth_sample_counts(inputs, t, sr)
    # inputs: controls, lo/frac tables, window, the frame ranges, dout;
    # outputs: the two control cotangents
    bound_ms, bound_by, flop_ms = synth_bound(
        SYNTH_BWD_FP32_OPS, SYNTH_BWD_FP64_OPS, counts,
        4.0 * (2 * b * nf * k + 2 * t + 2 * (t // nf) + 2 * (nf + 1) + b * t + 2 * b * nf * k))
    print(f"[timing] synth_backward: {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f}, "
          f"bound {bound_ms:.4f} ms ({bound_by}, issue rate, the work of the timed inputs: "
          f"{counts[2] / counts[0]:.4f} of the lane-samples below Nyquist, "
          f"{counts[1] / counts[0]:.4f} up to a lane's last one; at 67 TFLOP/s "
          f"{flop_ms:.4f}) | {card_line()}")
    return {
        "name": "synth_backward", "route": "cuda", "source": "sot_tpu_torch/csrc/synth.cu",
        "replaces": "sot_tpu/ops/pallas/synth.py:159",
        "max_abs_err": float((d_freqs - ref_f).abs().max()), "ms": ms, "device_ms": dev_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_flop_ms": flop_ms,
        "library_ms": None,
    }


def complements(alpha, beta, gaug):
    """(a, b, x) of the coupling on clipped augmented CDFs: a = cap - alpha,
    b = cap - beta over the body lanes, x the grid deltas."""
    cap = alpha[:, -1:]
    return ((cap - alpha[:, :-1]).contiguous(), (cap - beta[:, :-1]).contiguous(),
            (gaug[1:] - gaug[:-1]).contiguous())


def coupling_grads_case(what, a, b, x, exact):
    """Kernel B8 against its plain version, alpha_grads both ways; exact:
    bit for bit. Returns max|d|."""
    got = [kmerge.coupling_grads(a, b, x, ag) for ag in (True, False)]
    ref = [kmerge.coupling_grads_plain(a, b, x, ag) for ag in (True, False)]
    torch.cuda.synchronize()
    pairs = [(got[0][0], ref[0][0]), (got[0][1], ref[0][1]), (got[1][1], ref[1][1])]
    require(got[1][0] is None, "coupling_grads returned dS/da without alpha_grads")
    equal = [torch.equal(g, r) for g, r in pairs]
    rel = max(max_rel(g, r) for g, r in pairs)
    finite = all(bool(torch.isfinite(g).all()) for g, _ in pairs)
    print(f"[kernels] coupling gradient (B8) {what} a, b {tuple(a.shape)}: max|d|/max {rel:.3e} "
          f"(da, db with alpha_grads, db without); bit-equal {equal}"
          + (" (must be bit-equal)" if exact else f" (limit {COUPLING_GRAD_LIMIT})"))
    require(finite and (all(equal) if exact else rel <= COUPLING_GRAD_LIMIT),
            f"coupling gradient kernel disagrees on {what} rows")
    return max(float((g - r).abs().max()) for g, r in pairs)


def grad_plan_searches(a, b) -> int:
    """The binary searches of kernel 8's db side (merge.cu) on sorted rows:
    per warp of a row's 128 threads (32-column chunks w, w + 4, ...), one
    for each run of equal queries b along its columns and one more for each
    run whose value ties a value of a short of a's end."""
    cols = torch.arange(b.shape[1], device=b.device)
    warp = (cols // 32) % 4
    order = torch.argsort(warp * b.shape[1] + cols)  # each warp's columns, in its order
    bw, ww = b[:, order], warp[order]
    head = torch.ones_like(bw, dtype=torch.bool)
    head[:, 1:] = (bw[:, 1:] != bw[:, :-1]) | (ww[1:] != ww[:-1])
    neg_a, neg_b = (-a).contiguous(), (-bw).contiguous()
    tie = (torch.searchsorted(neg_a, neg_b, right=True)
           > torch.searchsorted(neg_a, neg_b, right=False)) & (bw != a[:, -1:])
    return int(head.sum() + (head & tie).sum())


def check_coupling_grads(rows, rng, dev):
    """[kernels] and [timing] for kernel 8 at one loss shape, on the real SOT
    rows ``rows`` (a list of (alpha, beta, gaug); the first checked, the rest
    timed): dyadic tie-heavy rows at the same width bit for bit (every
    prefix sum of the grid deltas is exact, and the result depends on a and
    b only through comparisons), unsorted rows (the whole-row scan); timed
    without alpha gradients, as the train step calls it. Returns its JSON
    entry."""
    a, b, x = complements(*rows[0])
    nrows, m = a.shape
    tag = f"[{nrows}, {m}]"
    err = coupling_grads_case(f"SOT rows of {BATCH} clips (real)", a, b, x, False)
    dy = [torch.from_numpy(t).to(dev) for t in dyadic_plane_rows(rng, BATCH * 16, m + 1)[:3]]
    coupling_grads_case("dyadic tie-heavy", *complements(*dy), True)
    un = [torch.from_numpy(t).to(dev) for t in random_plane_rows(rng, BATCH, 258, sort=False)[:3]]
    err = max(err, coupling_grads_case("unsorted", *complements(*un), False))
    searches = grad_plan_searches(a, b)
    print(f"[kernels] coupling gradient (B8) {tag} real rows: {searches} binary searches for "
          f"{nrows * m} columns ({searches / (nrows * m):.4f} a column)")

    inputs = [complements(*r) + (False,) for r in rows[1:]]
    ms = median_ms(kmerge.coupling_grads, inputs)
    dev_ms = device_ms(kmerge.coupling_grads, inputs, "coupling_grad_kernel")
    plain_ms = median_ms(kmerge.coupling_grads_plain, inputs)
    # reads a, b and x once, writes db; per column the head test (a compare)
    # and the result's three float64 operations, per search of this run's
    # rows ~log2(m) steps of a compare and two integer operations
    flops = nrows * m * 4 + searches * math.ceil(math.log2(m + 1)) * 3
    bound_ms, bound_by = roofline(flops, 4.0 * (2 * nrows * m + m + nrows * m))
    print(f"[timing] coupling_grads (B8) {tag}, no alpha gradients: {ms:.4f} ms (device "
          f"{dev_ms:.4f}), plain {plain_ms:.4f}, bound {bound_ms:.4f} ({bound_by}) | "
          f"{card_line()}")
    return {
        "name": "coupling_grads", "shape": tag, "route": "cuda",
        "source": "sot_tpu_torch/csrc/merge.cu", "replaces": "sot_tpu/ops/pallas/merge.py:235",
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


# the STFTs of the gated train steps that the frontend takes (T = 4096):
# (n_fft, hop, window): SOT-2048's loss STFT, the MSS scales with hop % 128
# == 0, SOT-512's loss STFT
FRONTEND_CASES = [(2048, 256, "flattop"), (2048, 512, None), (1024, 256, None),
                  (512, 128, None), (512, 256, "flattop")]


def windowed_dft64(n_fft: int, window: np.ndarray) -> torch.Tensor:
    """[n_fft, n_fft + 2] real-DFT basis [cos | -sin] times the f32 window,
    all in float64: the frontend's function without an f32 rounding."""
    k = np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * k[None, :] / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    return torch.from_numpy(basis * np.asarray(window, np.float32).astype(np.float64)[:, None])


def check_stft_frontend(dev, rng):
    """[kernels] and [timing] for B9 at each (n_fft, hop) of the gated path
    on [64, 4096] audio, against the plain f32 matmul and a float64 one. The
    JSON entry is the loss STFT 2048/256."""
    entry, err = None, 0.0
    for n_fft, hop, window in FRONTEND_CASES:
        win_np = hann_window(n_fft) if window is None else get_window(window, n_fft)
        basis = kstft.windowed_dft(n_fft, win_np, dev)
        win = kstft.window_tensor(win_np, dev)
        n_cols = 2 * (n_fft // 2 + 1)

        def audio():
            x = rng.uniform(-0.9, 0.9, (BATCH, 4096)).astype(np.float32)
            return torch.from_numpy(x).to(dev)

        inputs = [(audio(), n_fft, hop, win) for _ in range(TIMING_INPUTS)]
        plain_inputs = [(a, n_fft, hop, basis) for a, *_ in inputs]
        got = kstft.stft_frontend_kernel(*inputs[0])
        ref = kstft.stft_frontend_projection_plain(*plain_inputs[0])
        frames = kstft._frames(inputs[0][0], n_fft, hop)
        ref64 = torch.matmul(frames.double(), windowed_dft64(n_fft, win_np).to(dev))
        torch.cuda.synchronize()
        rel = max_rel(got, ref)
        rel64, plain64 = f64_rel(got, ref64), f64_rel(ref, ref64)
        err = max(err, float((got - ref).abs().max()))
        print(f"[kernels] stft frontend (B9) {n_fft}/{hop} {window or 'hann'} [{BATCH}, 4096] -> "
              f"{tuple(got.shape)}: max|d|/max {rel:.3e} (limit {FRONTEND_LIMIT}); against "
              f"float64: kernel {rel64:.3e}, plain f32 {plain64:.3e} (limit 2x plain)")
        require(got.shape == (BATCH, 4096 // hop, n_cols) and bool(torch.isfinite(got).all())
                and rel <= FRONTEND_LIMIT, f"stft frontend disagrees at {n_fft}/{hop}")
        require(rel64 <= 2.0 * plain64, f"stft frontend less accurate than f32 at {n_fft}/{hop}")
        ms = median_ms(kstft.stft_frontend_kernel, inputs)
        dev_ms = device_ms(kstft.stft_frontend_kernel, inputs, "stft_frontend_", 1)
        plain_ms = median_ms(kstft.stft_frontend_projection_plain, plain_inputs)
        lib_inputs = [(kstft._frames(a, n_fft, hop) * win,) for a, *_ in inputs]
        library_ms = median_ms(lambda f: torch.fft.rfft(f, dim=-1), lib_inputs)
        lib_dev_ms = device_ms(lambda f: torch.fft.rfft(f, dim=-1), lib_inputs, None)
        rows = BATCH * (4096 // hop)
        # the function is the windowed rfft of each pad_end frame: ~2.5 n log2 n
        # operations for a real FFT of n points plus n for the window, with the
        # audio and the window read and the spectra written once
        fft_ops = rows * (2.5 * n_fft * math.log2(n_fft) + n_fft)
        bound_ms, bound_by = roofline(fft_ops, 4.0 * (BATCH * 4096 + n_fft + rows * n_cols))
        print(f"[timing] stft_frontend (B9) {n_fft}/{hop}: {ms:.4f} ms (device {dev_ms:.4f}), "
              f"plain {plain_ms:.4f}, cuFFT rfft of the windowed frames {library_ms:.4f} "
              f"(device {lib_dev_ms:.4f}; kernel device time below it: {dev_ms < lib_dev_ms}), "
              f"bound {bound_ms:.4f} ({bound_by}; rfft {fft_ops / 1e6:.1f} MFLOP) | {card_line()}")
        if entry is None:
            entry = {"name": "stft_frontend", "route": "cuda",
                     "source": "sot_tpu_torch/csrc/stft.cu",
                     "replaces": "sot_tpu/ops/pallas/stft.py:69", "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms}
    entry["max_abs_err"] = err
    return entry


def conv_bound(x, dy_or_y, weight, dtype):
    """(bound_ms, bound_by, fp32_ms) of one 'same' conv pass (B10 forward or
    dx, or B11): 2 rows C_in C_out k W operations at the peak of the kernel's
    operand type (the bf16 tensor cores, or for float32 operands the 3xTF32
    rate: three TF32 products per f32-accurate one), x and the other
    activation read or written once in f32, the weight once; fp32_ms is the
    same bound at the FP32 CUDA-core peak, printed beside it."""
    rows, cin, width = x.shape
    cout, k = dy_or_y.shape[1], weight.shape[-1]
    flops = 2.0 * rows * cin * cout * k * width
    nbytes = 4.0 * (x.numel() + dy_or_y.numel() + weight.numel())
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS / 3
    return (*roofline(flops, nbytes, peak), roofline(flops, nbytes)[0])


def check_conv(dev, rng):
    """[kernels] and [timing] for B10 (forward and dx) and B11 (dW) at
    conv1's (1 -> 40) and the prefilter's (40 -> 40) shapes of the 64-clip
    batch ([1024, C, 285], k = 15), in both operand types: each within
    CONV_LIMIT of its plain version, its error against a float64 conv of the
    same rounded operands at most 2x the plain f32 version's, and two
    launches bit-equal. The JSON entries are the prefilter's in bf16, the
    gated path's."""
    entries, errs = {}, {"fwd": 0.0, "dw": 0.0}
    rows, width, k, ch = BATCH * 16, 285, 15, 40
    for cin in (1, ch):
        for dtype in (torch.float32, torch.bfloat16):
            def case():
                x = rng.standard_normal((rows, cin, width)).astype(np.float32)
                w = (rng.standard_normal((ch, cin, k)) / np.sqrt(cin * k)).astype(np.float32)
                dy = rng.standard_normal((rows, ch, width)).astype(np.float32)
                return tuple(torch.from_numpy(a).to(dev) for a in (x, w, dy))

            x, w, dy = case()
            wt = w.flip(-1).transpose(0, 1)  # dx: the tap-flipped, transposed weight

            def launch():
                return (kconv.conv1d_forward(x, w, dtype), kconv.conv1d_forward(dy, wt, dtype),
                        kconv.conv1d_weight(x, dy, k, dtype))

            got, again = launch(), launch()
            ref = (kconv.conv1d_same_plain(x, w, dtype), kconv.conv1d_same_plain(dy, wt, dtype),
                   kconv.conv1d_weight_plain(x, dy, k, dtype))
            xr, wr, dyr, wtr = (kconv.round_to(t, dtype).double() for t in (x, w, dy, wt))
            ref64 = (torch.nn.functional.conv1d(xr, wr, padding=k // 2),
                     torch.nn.functional.conv1d(dyr, wtr, padding=k // 2),
                     torch.nn.grad.conv1d_weight(xr, tuple(w.shape), dyr, padding=k // 2))
            torch.cuda.synchronize()
            rel = [max_rel(g, r) for g, r in zip(got, ref)]
            e64 = [f64_rel(g, r) for g, r in zip(got, ref64)]
            p64 = [f64_rel(g, r) for g, r in zip(ref, ref64)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            errs["fwd"] = max(errs["fwd"], *(float((g - r).abs().max())
                                           for g, r in zip(got[:2], ref[:2])))
            errs["dw"] = max(errs["dw"], float((got[2] - ref[2]).abs().max()))
            name = str(dtype).replace("torch.", "")
            print(f"[kernels] conv (B10/B11) x {tuple(x.shape)}, weight {tuple(w.shape)}, {name} "
                  f"operands: max|d|/max forward {rel[0]:.3e}, dx {rel[1]:.3e}, dW {rel[2]:.3e} "
                  f"(limit {CONV_LIMIT}); against float64 kernel / plain forward {e64[0]:.3e} / "
                  f"{p64[0]:.3e}, dx {e64[1]:.3e} / {p64[1]:.3e}, dW {e64[2]:.3e} / "
                  f"{p64[2]:.3e} (limit 2x plain); two launches bit-equal: {same}")
            require(all(bool(torch.isfinite(g).all()) for g in got) and max(rel) <= CONV_LIMIT,
                    f"conv kernels disagree at C_in {cin}, {name}")
            require(all(e <= 2.0 * p for e, p in zip(e64, p64)),
                    f"conv kernels above 2x the plain version's float64 error at C_in {cin}, "
                    f"{name}")
            require(same, f"conv kernels not bit-equal across two launches at C_in {cin}, {name}")

            inputs = [case() for _ in range(TIMING_INPUTS)]
            fwd = [(a, b, dtype) for a, b, _ in inputs]
            dxs = [(c, b.flip(-1).transpose(0, 1), dtype) for _, b, c in inputs]
            dws = [(a, c, k, dtype) for a, _, c in inputs]
            rounded = [tuple(kconv.round_to(t, dtype) for t in case) for case in inputs]
            lib_fwd = [(a, b) for a, b, _ in rounded]
            lib_dw = [(a, c) for a, _, c in rounded]

            def conv1d(a, b):
                return torch.nn.functional.conv1d(a, b, padding=k // 2)

            def conv1d_weight(a, c):
                return torch.nn.grad.conv1d_weight(a, (ch, cin, k), c, padding=k // 2)

            ms = {"fwd": median_ms(kconv.conv1d_forward, fwd),
                  "dx": median_ms(kconv.conv1d_forward, dxs),
                  "dw": median_ms(kconv.conv1d_weight, dws),
                  "fwd device": device_ms(kconv.conv1d_forward, fwd, "conv_fwd_mma_kernel"),
                  "dx device": device_ms(kconv.conv1d_forward, dxs, "conv_fwd_mma_kernel"),
                  "dw device": device_ms(kconv.conv1d_weight, dws, "conv_dw_", 2),
                  "fwd plain": median_ms(kconv.conv1d_same_plain, fwd),
                  "dw plain": median_ms(kconv.conv1d_weight_plain, dws),
                  "fwd library": median_ms(conv1d, lib_fwd),
                  "fwd library device": device_ms(conv1d, lib_fwd, None),
                  "dw library": median_ms(conv1d_weight, lib_dw),
                  "dw library device": device_ms(conv1d_weight, lib_dw, None)}
            bound = conv_bound(x, dy, w, dtype)
            rate = "bf16 tensor cores" if dtype == torch.bfloat16 else "3xTF32"
            print(f"[timing] conv C_in {cin} {name}: B10 forward {ms['fwd']:.4f} ms (device "
                  f"{ms['fwd device']:.4f}, plain {ms['fwd plain']:.4f}, cuDNN conv1d "
                  f"{ms['fwd library']:.4f}, device {ms['fwd library device']:.4f}), dx "
                  f"{ms['dx']:.4f} ms (device {ms['dx device']:.4f}); B11 dW {ms['dw']:.4f} ms "
                  f"(device {ms['dw device']:.4f}, plain {ms['dw plain']:.4f}, conv1d_weight "
                  f"{ms['dw library']:.4f}, device {ms['dw library device']:.4f}); bound "
                  f"{bound[0]:.4f} ms ({bound[1]}; {rate}) each, FP32-core bound "
                  f"{bound[2]:.4f} ms | {card_line()}")
            if cin == ch and dtype == torch.bfloat16:
                entries["fwd"] = {
                    "name": "conv1d_forward", "route": "cuda",
                    "source": "sot_tpu_torch/csrc/conv.cu",
                    "replaces": "sot_tpu/ops/pallas/conv.py:89", "ms": ms["fwd"],
                    "device_ms": ms["fwd device"], "plain_ms": ms["fwd plain"],
                    "bound_ms": bound[0], "bound_by": bound[1], "library_ms": ms["fwd library"]}
                entries["dw"] = {
                    "name": "conv1d_weight", "route": "cuda",
                    "source": "sot_tpu_torch/csrc/conv.cu",
                    "replaces": "sot_tpu/ops/pallas/conv.py:104", "ms": ms["dw"],
                    "device_ms": ms["dw device"], "plain_ms": ms["dw plain"],
                    "bound_ms": bound[0], "bound_by": bound[1], "library_ms": ms["dw library"]}
    entries["fwd"]["max_abs_err"], entries["dw"]["max_abs_err"] = errs["fwd"], errs["dw"]
    return [entries["fwd"], entries["dw"]]


def reset_launches() -> None:
    kcqt.launches = ksynth.launches = ksynth.backward_launches = 0
    kmerge.launches = krefgrad.launches = kplane.launches = kplane.backward_launches = 0
    kmerge.grad_launches = kstft.launches = kconv.launches = kconv.dw_launches = 0


def read_launches():
    return {"cqt_project": kcqt.launches, "synth_render": ksynth.launches,
            "synth_backward": ksynth.backward_launches, "merge_coupling": kmerge.launches,
            "ref_grad_beta": krefgrad.launches, "sot_plane_forward": kplane.launches,
            "sot_plane_backward": kplane.backward_launches,
            "coupling_grads": kmerge.grad_launches, "stft_frontend": kstft.launches,
            "conv1d_forward": kconv.launches, "conv1d_weight": kconv.dw_launches}


def timed_steps(mod, state, x_all, offsets):
    """Host-clock ms of each train step, each ending in a device synchronisation."""
    times, logs = [], {}
    for lo in offsets:
        t0 = time.perf_counter()
        logs = trainer.train_steps(mod, state, x_all, [lo])
        if mod.device.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, logs


# the configuration fields the dataset is generated from
DATA_FIELDS = ("data_seed", "dataset_size", "n_samples", "sample_rate", "freq_gen_min",
               "freq_gen_max", "amplitude_min", "amplitude_max", "n_sinusoids",
               "n_sinusoids_min", "mask_rand_amplitudes", "dataset_path")


def train_dataset(cfg, dev):
    """The config's train split, generated on the card by the port's data
    module and kept resident."""
    t0 = time.perf_counter()
    splits = data_lib.dataset_from_config(cfg, device=dev)
    x_all = torch.from_numpy(data_lib.peak_normalize(splits["train"].x)).to(dev)
    torch.cuda.synchronize()
    print(f"[train] dataset: {cfg.dataset_size} clips generated on the card, train split "
          f"{tuple(x_all.shape)} resident ({(time.perf_counter() - t0) * 1e3:.1f} ms set-up)")
    return x_all


def train(cfg, dev, x_all, kernels="auto", on=(), window=True, gates_name="gated"):
    """Train steps at batch 64 from the device-resident dataset: 4 steps
    with their launch counts (each kernel in ``on`` launched, every other
    kernel not), finite loss and grad_norm, changed parameters; with
    ``window``, 32 more timed steps and a profile of one more.
    ``gates_name`` names a ``KernelGates`` in the printed label."""
    base = get_experiment("SOT-2048")
    require(all(getattr(base, f) == getattr(cfg, f) for f in DATA_FIELDS),
            f"{cfg.name} draws another dataset than the one generated")
    label = f"{cfg.name} kernels={kernels if isinstance(kernels, str) else gates_name}"
    mod = build_modules(cfg, device=dev, generator=torch.Generator().manual_seed(cfg.seed),
                        kernels=kernels)
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
    print(f"[train] {label}: {TRAIN_STEPS} steps x {BATCH} clips: step ms "
          f"{', '.join(f'{v:.3f}' for v in times)}; last loss {loss:.6f} (MSS "
          f"{float(logs['loss/MSSLoss']):.6f}, W1D {float(logs['loss/Wasserstein1D']):.6f}), "
          f"grad_norm {gnorm:.6f}, max parameter change {moved:.3e}")
    print(f"[train] {label}: launches during the {TRAIN_STEPS} steps: {launches} (route "
          f"{wasserstein_lib.w2_route(len(mod.x_pos), kernels)!r})")
    require(math.isfinite(loss) and math.isfinite(gnorm), "non-finite train loss or grad_norm")
    require(moved > 0.0, "the parameters did not change")
    require(all(launches[k] > 0 for k in on), f"{label}: a kernel of the route was not launched")
    require(all(v == 0 for k, v in launches.items() if k not in on),
            f"{label}: a kernel off the route was launched")
    if not window:
        return launches

    window, logs = timed_steps(mod, state, x_all, offsets[TRAIN_STEPS:-1])
    total = sum(window)
    frames = WINDOW_STEPS * BATCH * 16
    print(f"[train] {label}: window of {WINDOW_STEPS} steps x {BATCH} clips x 16 frames: "
          f"{frames} frames in {total:.3f} ms of summed step time = {frames / total * 1e3:.1f} "
          f"train frames/s ({cfg.name} train step, port); step ms median "
          f"{statistics.median(window):.3f}, min {min(window):.3f}, max {max(window):.3f}; "
          f"last loss {float(logs['loss/total']):.6f}")
    print(f"[train] {label}: window step ms: {', '.join(f'{v:.3f}' for v in window)}")
    print(f"[train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    busy = profile_device(f"one {label} train step",
                          lambda: trainer.train_steps(mod, state, x_all, offsets[-1:]), top=30)
    if busy is not None:
        median = statistics.median(window)
        print(f"[train] {label}: device busy {busy:.4f} ms of one step against the window's "
              f"median step {median:.3f} ms: idle share {1.0 - busy / median:.3f}")
    return launches


def conv_gate_ab(cfg, dev, x_all):
    """Information only (no preset changes): the device busy ms of one
    SOT-2048 train step under ``auto`` (cuDNN's f32 convs) and under
    CONV_F32 (the k > 1 convs on kernels 10 and 11 in 3xTF32), each model
    warmed by two steps, profiled in turns (auto, kernels, kernels, auto)."""
    mods = {}
    for name, gates in (("auto", "auto"), ("auto + conv kernels f32", CONV_F32)):
        mod = build_modules(cfg, device=dev, generator=torch.Generator().manual_seed(cfg.seed),
                            kernels=gates)
        state = trainer.init_state(mod)
        trainer.train_steps(mod, state, x_all, [0, BATCH])
        mods[name] = (mod, state)
    busy = {name: [] for name in mods}
    for i, name in enumerate(("auto", "auto + conv kernels f32", "auto + conv kernels f32",
                              "auto")):
        mod, state = mods[name]
        busy[name].append(profile_device(
            f"one SOT-2048 step, {name} (conv gate A/B, turn {i + 1})",
            lambda: trainer.train_steps(mod, state, x_all, [2 * BATCH]), top=0))
    print(f"[train] conv gate A/B, information only: device busy ms of one SOT-2048 step, "
          + "; ".join(f"{name} {', '.join('not measured' if v is None else f'{v:.4f}' for v in vs)}"
                      for name, vs in busy.items())
          + f" | {card_line()}")


def check_eval_512(cfg, dev):
    """[eval-512]: the port's ``evaluate`` with the SOT-512 seed-42 weights
    on the predict golden's 64 clips and their f0, on the card, against the
    JAX package's ``evaluate`` stored in the SOT-512 golden."""
    with np.load(GOLDEN) as z:
        split = data_lib.SplitArrays(z["x"], z["f0"], np.zeros((len(z["x"]), 1), np.float32))
    with np.load(GOLDEN_512) as z:
        ref = {k[len("eval/"):]: float(z[k]) for k in z.files if k.startswith("eval/")}
    mod = build_modules(cfg, device=dev)
    load_golden_weights(mod, GOLDEN_512)
    reset_launches()
    got = trainer.evaluate(mod, trainer.make_eval_step(mod), split, len(split))
    print(f"[eval-512] launches during evaluate: {read_launches()}")
    eval_metrics_check("eval-512", got, ref)


def eval_metrics_check(phase, got, ref, ref_name="JAX") -> None:
    """The port's ``evaluate`` metrics against JAX's (or another reference,
    ``ref_name``): LSD, MSE, MSS and the loss terms within EVAL_REL, the
    pitch accuracies and the octave difference within one frame
    (EVAL_FRAME)."""
    require(set(got) == set(ref), f"eval metric names {sorted(got)} != {sorted(ref)}")
    frame_wise = ("raw_pitch_accuracy", "raw_chroma_accuracy", "octave_difference")
    misses = []
    for k in sorted(ref):
        d = abs(got[k] - ref[k])
        ok = d <= EVAL_FRAME + 1e-7 if k in frame_wise else d <= EVAL_REL * abs(ref[k])
        misses += [] if ok else [k]
        print(f"[{phase}] {k}: port {got[k]:.6f} {ref_name} {ref[k]:.6f} |d| {d:.3e} ("
              + (f"limit {EVAL_FRAME:.3e}, one frame)" if k in frame_wise
                 else f"rel {d / abs(ref[k]):.3e}, limit {EVAL_REL})"))
    require(all(math.isfinite(v) for v in got.values()), f"{phase}: non-finite eval metrics")
    require(not misses, f"{phase}: eval metrics disagree with {ref_name}: {misses}")


def eval_golden():
    """The SOT-2048 evaluation golden (``tests/_torch_golden_eval2048.py``)
    and the predict golden's clips and f0."""
    with np.load(GOLDEN_EVAL) as z:
        g = {k: z[k] for k in z.files}
    with np.load(GOLDEN) as z:
        g["x"], g["f0"] = z["x"], z["f0"]
    return g


def eval_2048_form(cfg, dev, form, g) -> None:
    """[eval-2048] one form: the port's ``evaluate`` with the SOT-2048
    seed-42 weights on the 64 clips against JAX's (``eval_metrics_check``)."""
    mod = build_modules(cfg.replace(**EVAL_FORMS[form]), device=dev)
    load_golden_weights(mod)
    split = data_lib.SplitArrays(g["x"], g["f0"], np.zeros((len(g["x"]), 1), np.float32))
    reset_launches()
    got = trainer.evaluate(mod, trainer.make_eval_step(mod), split, len(split))
    print(f"[eval-2048] {form}: launches during evaluate: {read_launches()}")
    eval_metrics_check(f"eval-2048 {form}", got,
                       {k[len(f"eval/{form}/"):]: float(g[k]) for k in g
                        if k.startswith(f"eval/{form}/")})


def correction_factors_check(mod, g, shift: str) -> None:
    """[eval-2048] both corrections on the golden's pitches times
    CORRECTION_SHIFTS[shift] with ``mod``'s thresholds and STFT gate: the
    clip factors equal to JAX's on every clip (a clip that flips is named),
    the quantities each decision compares within DECISION_REL of JAX's."""
    x = torch.from_numpy(g["x"]).to(mod.device)
    p = torch.from_numpy((g["pitch_hz"] * np.float32(CORRECTION_SHIFTS[shift]))
                         .astype(np.float32)).to(mod.device)
    kwargs = trainer.correction_kwargs(mod)
    for kind, fn, extra in (("octave", metrics_lib.octave_factors, {}),
                            ("comb", metrics_lib.comb_factors,
                             {"margin": mod.config.comb_correction_margin})):
        factor, quantities = fn(x, p, **kwargs, **extra)
        factor = factor.cpu().numpy()
        ref = g[f"{kind}/{shift}/factor"]
        flips = [f"clip {i}: port {factor[i]} JAX {ref[i]}" for i in np.flatnonzero(factor != ref)]
        errs = {k: float(np.abs(v.cpu().numpy() - g[f"{kind}/{shift}/{k}"]).max()
                         / max(float(np.abs(g[f"{kind}/{shift}/{k}"]).max()), 1e-30))
                for k, v in quantities.items()}
        print(f"[eval-2048] {kind} correction, pitch x{shift}: factors "
              f"{dict(zip(*(t.tolist() for t in np.unique(ref, return_counts=True))))}, equal on "
              f"{len(ref) - len(flips)} of {len(ref)} clips; decision quantities max|d|/max "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (limit {DECISION_REL})")
        require(not flips, f"{kind} correction x{shift}: factors differ from JAX: {flips}")
        require(max(errs.values()) <= DECISION_REL,
                f"{kind} correction x{shift}: decision quantities differ from JAX: {errs}")


def predict_comb_check(cfg, dev, g, kernels) -> None:
    """[eval-2048] ``predict`` with ``inference_comb_correction`` under
    ``kernels``: the corrected pitch against JAX's predict (rel within 1e-3,
    the predict golden's limit) and, from the golden's own pitches, the comb
    factors equal to JAX's on every clip; under the STFT frontend gate, the
    correction's STFT launches kernel 9."""
    mod = build_modules(cfg.replace(inference_comb_correction=True), device=dev, kernels=kernels)
    load_golden_weights(mod)
    reset_launches()
    x = torch.from_numpy(g["x"]).to(dev)
    out = predict(mod, x)
    launches = read_launches()
    pitch = out["pitch_hz"].cpu().numpy()
    rel = float(np.max(np.abs(pitch - g["predict_comb/pitch_hz"]) / g["predict_comb/pitch_hz"]))
    factor, _ = metrics_lib.comb_factors(x, torch.from_numpy(g["pitch_hz"]).to(dev),
                                         margin=cfg.comb_correction_margin,
                                         **trainer.correction_kwargs(mod))
    flips = np.flatnonzero(factor.cpu().numpy() != g["comb/1/factor"]).tolist()
    name = kernels if isinstance(kernels, str) else "gated"
    print(f"[eval-2048] predict with inference_comb_correction, kernels={name}: pitch_hz max rel "
          f"diff from JAX's {rel:.3e}; comb factors on JAX's pitches equal on "
          f"{len(pitch) - len(flips)} of {len(pitch)} clips; launches during predict {launches}")
    require(bool(np.isfinite(pitch).all()) and pitch.shape == g["predict_comb/pitch_hz"].shape,
            "predict with the comb correction: bad output")
    require(not flips, f"kernels={name}: comb factors differ from JAX's on clips {flips}")
    if mod.kernels.stft_frontend and dev.type == "cuda":
        require(launches["stft_frontend"] > 0, "the correction's STFT did not launch kernel 9")
    if mod.kernels == PRESETS["auto"]:
        require(rel <= 1e-3, "predict with the comb correction disagrees with JAX")


def check_eval_2048(cfg, dev) -> None:
    """[eval-2048]: the port's ``evaluate`` with the SOT-2048 seed-42
    weights in every form of EVAL_FORMS against JAX's, both corrections'
    factors and decisions at every pitch shift, and ``predict`` with the
    comb correction under ``auto`` and GATED."""
    g = eval_golden()
    for form in EVAL_FORMS:
        eval_2048_form(cfg, dev, form, g)
    mod = build_modules(cfg, device=dev)
    for shift in CORRECTION_SHIFTS:
        correction_factors_check(mod, g, shift)
    predict_comb_check(cfg, dev, g, "auto")
    predict_comb_check(cfg, dev, g, GATED)


# ---------------------------------------------------------------------------
# [train-run]: the training run through the CLI
# ---------------------------------------------------------------------------

TRAIN_RUN_EPOCHS = 3     # the run: 3 epochs, an evaluation after each
ROLL_OFF_LIMIT = 1e-5    # the roll-off FIR, card against CPU on one signal: max|d| / max


def run_records(out: str):
    with open(os.path.join(out, "log.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def record_keys(cfg, split: str) -> set:
    """The keys of the JAX package's ``train``, ``val`` and ``probe``
    records for ``cfg`` (``sot_tpu/training/trainer.py:train``): the loss
    terms, then grad_norm and samples_per_sec or the metric suite."""
    terms = {f"loss/{'MSSLoss' if lc.kind == 'mss' else 'Wasserstein1D'}" for lc in cfg.losses}
    terms |= {"loss/total", "split", "step"}
    if split == "train":
        return terms | {"grad_norm", "samples_per_sec"}
    return terms | set(cfg.evaluation_metrics) | ({"probe"} if split == "probe" else set())


class ChunkSpy:
    """Wraps ``trainer.train_steps`` inside ``train()``: each chunk's batch
    offsets, its state object, the parameters before and after it, and its
    host-clock seconds (ending in a device synchronisation)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, mod, state, x_all, offsets):
        before = {k: v.detach().cpu().clone() for k, v in mod.encoder.state_dict().items()}
        t0 = time.perf_counter()
        logs = self.fn(mod, state, x_all, offsets)
        if mod.device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = {k: v.detach().cpu().clone() for k, v in mod.encoder.state_dict().items()}
        self.calls.append({"offsets": np.asarray(offsets).copy(), "state": id(state),
                           "before": before, "after": after, "seconds": seconds})
        return logs


class SaveSpy:
    """Wraps ``checkpoint.save``: the (tag, step) of each save and a copy of
    what ``last`` held in memory when it was written."""

    def __init__(self, fn):
        self.fn, self.saves, self.last = fn, [], None

    def __call__(self, checkpoint_dir, mod, state, step, tag="best-lsd"):
        path = self.fn(checkpoint_dir, mod, state, step, tag=tag)
        self.saves.append((tag, int(step)))
        if tag == "last":
            self.last = ckpt_lib.payload(mod, state, step)
        return path


def run_cli(argv, chunks=False):
    """``cli.main(argv)`` in this process, with ``train_steps`` and
    ``checkpoint.save`` spied on; returns (stdout, ChunkSpy, SaveSpy)."""
    import io

    chunk_spy, save_spy = ChunkSpy(trainer.train_steps), SaveSpy(ckpt_lib.save)
    buf = io.StringIO()
    with mock.patch.object(trainer, "train_steps", chunk_spy), \
            mock.patch.object(ckpt_lib, "save", save_spy), contextlib.redirect_stdout(buf):
        rc = cli_lib.main(argv)
    require(rc == 0, f"cli {argv[0]} returned {rc}")
    return buf.getvalue(), chunk_spy, save_spy


def tree_diff(a, b, path="") -> list:
    """The paths at which two checkpoint payloads differ (tensors bit for bit)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        ok = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
              and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
        return [] if ok else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [d for k in a for d in tree_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in tree_diff(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def steps_per_sec(spy: ChunkSpy) -> float:
    steps = sum(len(c["offsets"]) for c in spy.calls)
    return steps / sum(c["seconds"] for c in spy.calls)


def check_train_run(dev, overrides=None, dataset_size=None, x_all=None) -> None:
    """[train-run]: ``cli train`` of SOT-2048 under ``auto`` for three epochs
    with an evaluation after each and ``--final-eval``; its records, best
    metrics, checkpoints and test metrics; kernels 1-5 launched during it;
    the ``last`` checkpoint restored bit for bit into fresh modules; two
    resumes from it for one more epoch (JAX's restarted batch order, their
    parameters compared); ``cli evaluate`` of ``best-lsd`` against the best
    val record; ``cli predict`` from it on 64 clips; SOT-2048-SS-Probes with
    two probes; MSS-LogLin 4 train steps and its roll-off on the card
    against the CPU. ``overrides`` and ``dataset_size`` shrink the configs
    (the CPU rehearsal in the tests); the card runs them at full width."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    overrides = dict(overrides or {})
    flags = [a for k, v in overrides.items() for a in ("--set", f"{k}={json.dumps(v)}")]
    if dataset_size:
        flags += ["--dataset-size", str(dataset_size)]
    flags += device_flags(dev)
    cfg = get_experiment("SOT-2048", **overrides,
                         **({"dataset_size": dataset_size} if dataset_size else {}))
    bs = cfg.batch_size
    epoch = int((1 - 0.2 - 0.1) * cfg.dataset_size) // bs  # data.random_split's train share
    steps = TRAIN_RUN_EPOCHS * epoch
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_run_", dir=os.path.join(ROOT, "runs"))
    card = card_line() if dev.type == "cuda" else "cpu"
    try:
        out = os.path.join(tmp, "run")
        reset_launches()
        t0 = time.perf_counter()
        _, chunks, saves = run_cli(["train", "--experiment", "SOT-2048", "--kernels", "auto",
                                    "--steps", str(steps), "--eval-every", str(epoch),
                                    "--final-eval", "--out", out] + flags)
        wall = time.perf_counter() - t0
        launches = read_launches()
        records = run_records(out)
        train_recs = [r for r in records if r["split"] == "train"]
        val_recs = [r for r in records if r["split"] == "val"]
        want = [epoch * (i + 1) for i in range(TRAIN_RUN_EPOCHS)]
        print(f"[train-run] cli train SOT-2048 --kernels auto --steps {steps} --eval-every "
              f"{epoch} --final-eval: {len(records)} records, train at "
              f"{[int(r['step']) for r in train_recs]}, val at "
              f"{[int(r['step']) for r in val_recs]}, val LSD "
              f"{[round(r['log_spectral_distance'], 4) for r in val_recs]}; checkpoints saved "
              f"{saves.saves}; {wall:.1f} s of host clock in all")
        require([int(r["step"]) for r in train_recs] == want, "train records at the wrong steps")
        require([int(r["step"]) for r in val_recs] == want, "val records at the wrong steps")
        require(all(set(r) == record_keys(cfg, "train") for r in train_recs),
                f"train record keys {sorted(train_recs[0])} differ from JAX's")
        require(all(set(r) == record_keys(cfg, "val") for r in val_recs),
                f"val record keys {sorted(val_recs[0])} differ from JAX's")
        require(all(math.isfinite(v) for r in records for v in r.values()
                    if isinstance(v, float)), "non-finite values in the run's records")
        with open(os.path.join(out, "best_metrics.json")) as fh:
            best = json.load(fh)
        best_rec = min(val_recs, key=lambda r: r["log_spectral_distance"])
        require(best == {k: v for k, v in best_rec.items() if k not in ("split", "step")},
                "best_metrics.json is not the val record of lowest LSD")
        best_step = int(best_rec["step"])
        require([s for t, s in saves.saves if t == "best-lsd"][-1] == best_step,
                "best-lsd was not saved at the best val record's step")
        ckpts = os.path.join(out, "checkpoints")
        require(sorted(os.listdir(ckpts)) == ["best-lsd", "last"],
                f"checkpoint tags {sorted(os.listdir(ckpts))}")
        for name in ("test_metrics.json", "test_metrics_octcorr.json", "test_metrics_comb.json"):
            with open(os.path.join(out, name)) as fh:
                m = json.load(fh)["test_metrics"]
            require(set(m) == record_keys(cfg, "val") - {"split", "step"} and
                    all(math.isfinite(v) for v in m.values()), f"{name}: bad test metrics")
        print(f"[train-run] test RPA plain / octcorr / comb: "
              + " / ".join(f"{json.load(open(os.path.join(out, n)))['test_metrics']['raw_pitch_accuracy']:.6f}"
                           for n in ("test_metrics.json", "test_metrics_octcorr.json",
                                     "test_metrics_comb.json")))
        print(f"[train-run] launches during cli train (train steps, evaluations, final "
              f"evaluation): {launches}")
        if dev.type == "cuda":
            require(all(launches[k] > 0 for k in ("cqt_project", "synth_render", "synth_backward",
                                                    "merge_coupling", "ref_grad_beta")),
                    "a kernel of SOT-2048's auto route (1-5) was not launched during cli train")
        print(f"[train-run] host clock: {steps_per_sec(chunks):.2f} train steps/s over the "
              f"{len(chunks.calls)} epochs (each ending in a synchronisation); samples_per_sec "
              f"records {[round(r['samples_per_sec'], 1) for r in train_recs]} | {card}")

        # the checkpoint round trip: `last` into fresh modules and state
        last = os.path.join(ckpts, "last")
        require(saves.last is not None, "no in-memory copy of `last` was taken")
        on_disk = tree_diff(ckpt_lib.load(last), saves.last)
        mod = build_modules(cfg, device=dev, generator=torch.Generator().manual_seed(1))
        state = trainer.init_state(mod, seed=cfg.seed + 1)
        step = ckpt_lib.restore(last, mod, state)
        restored = tree_diff(ckpt_lib.payload(mod, state, step), saves.last)
        n_tensors = sum(1 for _ in mod.encoder.state_dict()) + 3 * len(
            state.optimizer.state_dict()["state"])
        print(f"[train-run] checkpoint `last` (step {step}): the file against the in-memory "
              f"state: {len(on_disk)} differences; restored into fresh modules and state: "
              f"{len(restored)} differences over the encoder's parameters, Adam's moments and "
              f"steps ({n_tensors} tensors), the LambdaLR state, the generator state and the step")
        require(not on_disk and not restored, f"checkpoint round trip differs: {on_disk + restored}")
        require(step == steps and state.scheduler.last_epoch == steps,
                "the restored step or schedule is wrong")

        # resume twice from `last`: one more epoch each, in JAX's restarted
        # order; on the card again with cuDNN's deterministic algorithms, the
        # one setting that makes two identical steps bit-equal there (its
        # default f32 conv backward is not deterministic)
        for deterministic in (False, True) if dev.type == "cuda" else (False,):
            resume_twice(cfg, dev, tmp, last, steps, epoch, flags, card, deterministic)

        # evaluate and predict from the run's best-lsd checkpoint
        best_ckpt = os.path.join(ckpts, "best-lsd")
        # the run's train_config.json travels with the checkpoint
        text, _, _ = run_cli(["evaluate", "--ckpt", best_ckpt, "--split", "val"]
                             + device_flags(dev))
        got = json.loads(text)["val_metrics"]
        eval_metrics_check("train-run evaluate", got, best, "best val record")
        clips = os.path.join(tmp, "clips.npy")
        with np.load(GOLDEN) as z:
            np.save(clips, z["x"])
            frames = -(-(z["x"].shape[1] - 1) // cfg.cqt_hop_length)
        preds = os.path.join(tmp, "preds.npz")
        run_cli(["predict", "--ckpt", best_ckpt, "--input", clips, "--output", preds]
                + device_flags(dev))
        with np.load(preds) as z:
            shapes = {k: z[k].shape for k in z.files}
            finite = all(bool(np.isfinite(z[k]).all()) for k in z.files)
        print(f"[train-run] cli predict --ckpt best-lsd on {BATCH} clips: {shapes}")
        require(finite and shapes == {"pitch_hz": (BATCH, frames), "pitch_unit": (BATCH, frames),
                                      "weights": (BATCH, frames, cfg.n_modes)},
                "cli predict from the run checkpoint: bad output")

        # init-probe restarts: two probes of one epoch, then one epoch more
        out_p = os.path.join(tmp, "probes")
        cfg_p = get_experiment("SOT-2048-SS-Probes", **overrides, n_init_probes=2,
                               probe_steps=epoch)
        _, chunks_p, _ = run_cli(["train", "--experiment", "SOT-2048-SS-Probes", "--kernels",
                                  "auto", "--set", "n_init_probes=2", "--set",
                                  f"probe_steps={epoch}", "--steps", str(2 * epoch), "--out",
                                  out_p] + flags)
        recs = run_records(out_p)
        probes = [r for r in recs if r["split"] == "probe"]
        trains = [r for r in recs if r["split"] == "train"]
        require(len(probes) == 2 and [int(r["probe"]) for r in probes] == [0, 1],
                f"{len(probes)} probe records")
        require(all(set(r) == record_keys(cfg_p, "probe") for r in probes), "probe record keys")
        require(int(trains[0]["step"]) == 2 * epoch, "the first train record after the probes "
                                                     "is not at 2 epochs")
        win = min(range(2), key=lambda i: probes[i]["log_spectral_distance"])
        require(len(chunks_p.calls) == 3, f"{len(chunks_p.calls)} chunks, expected 3")
        main_chunk, winner = chunks_p.calls[2], chunks_p.calls[win]
        same = (main_chunk["state"] == winner["state"]
                and not tree_diff(main_chunk["before"], winner["after"]))
        print(f"[train-run] SOT-2048-SS-Probes, 2 probes of {epoch} steps: val LSD "
              f"{[round(r['log_spectral_distance'], 4) for r in probes]}; the run went on from "
              f"probe {win} (its parameters and its optimizer state: {same}); first train "
              f"record at step {int(trains[0]['step'])}; host clock "
              f"{steps_per_sec(chunks_p):.2f} steps/s, samples_per_sec "
              f"{trains[0]['samples_per_sec']:.1f} | {card}")
        require(same, "the continued run is not the probe of lowest val LSD")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_mss_loglin(dev, overrides, dataset_size, x_all)
    print(f"[train-run] the phase took {time.perf_counter() - t_phase:.1f} s of host clock")


def resume_twice(cfg, dev, tmp, last, steps, epoch, flags, card, deterministic) -> None:
    """[train-run] two ``cli train --resume last`` runs of one more epoch:
    each in ``default_rng(seed).permutation(epoch)``'s order (JAX's resume
    order), their parameters compared; under ``deterministic`` (cuDNN's
    deterministic algorithms) required bit-equal."""
    bs, tag = cfg.batch_size, "cudnn.deterministic" if deterministic else "default"
    resumed = []
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        for i in range(2):
            out_r = os.path.join(tmp, f"resume-{tag}-{i}")
            _, chunks_r, _ = run_cli(["train", "--experiment", "SOT-2048", "--kernels", "auto",
                                      "--steps", str(steps + epoch), "--eval-every", str(epoch),
                                      "--out", out_r, "--resume", last] + flags)
            recs = [r for r in run_records(out_r) if r["split"] == "train"]
            order = np.random.default_rng(cfg.seed).permutation(epoch) * bs
            require([int(r["step"]) for r in recs] == [steps + epoch],
                    f"resume: train records at {[r['step'] for r in recs]}")
            require(len(chunks_r.calls) == 1
                    and np.array_equal(chunks_r.calls[0]["offsets"], order),
                    "resume: the batch order is not default_rng(seed).permutation(epoch)'s")
            resumed.append(ckpt_lib.load(os.path.join(out_r, "checkpoints", "last")))
            print(f"[train-run] resume {i + 1} ({tag}) from step {steps}: train record at step "
                  f"{int(recs[0]['step'])}, batch order default_rng({cfg.seed})"
                  f".permutation({epoch}) (JAX's resume order); host clock "
                  f"{steps_per_sec(chunks_r):.2f} steps/s, samples_per_sec "
                  f"{recs[0]['samples_per_sec']:.1f} | {card}")
    finally:
        torch.backends.cudnn.deterministic = old
    d = max(float((resumed[0]["encoder"][k] - resumed[1]["encoder"][k]).abs().max())
            for k in resumed[0]["encoder"])
    diffs = tree_diff(resumed[0], resumed[1])
    print(f"[train-run] two resumes from one checkpoint ({tag}): parameters max|d| {d:.3e}; "
          f"bit-equal {not diffs} ({len(diffs)} differing tensors or fields: {diffs[:6]})")
    if deterministic:
        require(not diffs, "two resumes under cuDNN's deterministic algorithms differ")


def device_flags(dev) -> list:
    return [] if dev.type == "cuda" else ["--device", str(dev)]


def check_mss_loglin(dev, overrides, dataset_size, x_all) -> None:
    """[train-run] MSS-LogLin: 4 train steps (finite loss and grad_norm) and
    the roll-off: the synth render with the roll-off on the card against the
    CPU from the same controls (the synth's own limits), and the FIR alone
    on the card's unfiltered render against the CPU's FIR of it
    (ROLL_OFF_LIMIT)."""
    cfg = get_experiment("MSS-LogLin", **overrides,
                         **({"dataset_size": dataset_size} if dataset_size else {}))
    if x_all is None:
        x_all = torch.from_numpy(data_lib.peak_normalize(
            data_lib.dataset_from_config(cfg, device=dev)["train"].x)).to(dev)
    mod = build_modules(cfg, device=dev, generator=torch.Generator().manual_seed(cfg.seed),
                        kernels="auto")
    state = trainer.init_state(mod)
    reset_launches()
    epoch = len(x_all) // cfg.batch_size
    times, logs = timed_steps(mod, state, x_all,
                              (np.arange(TRAIN_STEPS) % epoch) * cfg.batch_size)
    loss, gnorm = float(logs["loss/total"]), float(logs["grad_norm"])
    print(f"[train-run] MSS-LogLin kernels=auto: {TRAIN_STEPS} steps x {cfg.batch_size} clips: "
          f"step ms {', '.join(f'{v:.3f}' for v in times)}; last loss {loss:.6f}, grad_norm "
          f"{gnorm:.6f}; launches {read_launches()}")
    require(math.isfinite(loss) and math.isfinite(gnorm), "MSS-LogLin: non-finite loss")

    synth = synths_lib.Sinusoidal(n_samples=cfg.n_samples, sample_rate=cfg.sample_rate,
                                  amp_scale_fn=None, freq_scale_fn=None, harmonic=True,
                                  apply_roll_off=True)
    plain = dataclasses.replace(synth, apply_roll_off=False)
    amps, freqs = synth_controls(np.random.default_rng(11), dev, cfg.sample_rate)
    with torch.no_grad():
        card = synth.get_signal(amps, freqs)
        cpu = synth.get_signal(amps.cpu(), freqs.cpu())
        raw = plain.get_signal(amps, freqs)
        mag = fir_lib.slope_frequency_response(6.0, n_freqs=65, f_ref=500.0)[0]
        fir_card = fir_lib.frequency_filter(raw, mag.to(dev).expand(raw.shape[0], -1))
        fir_cpu = fir_lib.frequency_filter(raw.cpu(), mag.expand(raw.shape[0], -1))
    err = float((card.cpu() - cpu).abs().max())
    corr = float(np.corrcoef(card.cpu().numpy().ravel(), cpu.numpy().ravel())[0, 1])
    fir_err = float((fir_card.cpu() - fir_cpu).abs().max() / fir_cpu.abs().max())
    print(f"[train-run] MSS-LogLin roll-off render {tuple(card.shape)}, card against CPU from "
          f"the same controls: max|d| {err:.3e} (limit 2e-2), corr {corr:.7f} (limit 0.9999); "
          f"the FIR alone on one signal: max|d|/max {fir_err:.3e} (limit {ROLL_OFF_LIMIT}); the "
          f"roll-off takes {float(raw.abs().max() / card.abs().max()):.3f}x off the peak")
    require(err <= 2e-2 and corr > 0.9999, "MSS-LogLin: the roll-off render disagrees")
    require(fir_err <= ROLL_OFF_LIMIT, "MSS-LogLin: the roll-off FIR on the card disagrees")


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ab-parent", metavar="PATH", nargs="+", default=[],
                        help="other plane.cu, merge.cu or refgrad.cu sources (e.g. an earlier "
                             "commit's, chosen by file name) to time kernels 6 and 7, 4 and 8 or 5 "
                             "against, in turns")
    args = parser.parse_args()
    for path in args.ab_parent:
        if os.path.basename(path) not in AB_SOURCES or not os.path.isfile(path):
            parser.error(f"--ab-parent takes existing {', '.join(AB_SOURCES)} files: {path}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    set_precision_policy()

    seconds = _build.build(["cqt", "synth", "merge", "refgrad", "plane", "stft", "conv"])
    print(f"[build] nvcc sm_90a, parallel: {json.dumps(seconds)} s")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    cfg = get_experiment("SOT-2048")
    cfg512 = get_experiment("SOT-512")
    rng = np.random.default_rng(0)
    kernels = [check_cqt(cfg, dev, rng), check_synth(cfg, dev, rng)]
    mod = check_golden(cfg, dev)
    serving_launches, last_request = serve(cfg, mod)
    profile_device("one served request", lambda: predict(mod, last_request))

    # the train step's kernels on real SOT rows of the trained models
    batches = make_requests(cfg, dev, 1 + TIMING_INPUTS, seed=3000)
    rows = [sot_rows(mod, torch.from_numpy(b).to(dev)) for b in batches]
    mod512 = build_modules(cfg512, device=dev)
    load_golden_weights(mod512, GOLDEN_512)
    rows512 = [sot_rows(mod512, torch.from_numpy(b).to(dev)) for b in batches]
    shapes = {"[1024, 258]": rows512, "[1024, 1026]": rows}
    kernels += [check_synth_backward(cfg, dev, rng), check_merge(rows), check_merge(rows512),
                check_refgrad(rows)]
    check_refgrad(rows512, entry=False)
    rank_row_checks(dev, np.random.default_rng(9))
    rank_relaunch_check(shapes)
    with np.load(GOLDEN_512) as z:
        golden_512 = {k: z[k] for k in z.files}
    plane_errs = plane_kernel_checks(dev, rng, golden_512)
    plane_relaunch_check(shapes)
    plane_entries = plane_timings(shapes)
    for entry in plane_entries:
        entry["max_abs_err"] = plane_errs[0 if entry["name"] == "sot_plane_forward" else 1]
    kernels += plane_entries
    for path in args.ab_parent:
        (plane_ab if os.path.basename(path) == "plane.cu" else rank_ab)(path, shapes)
    kernels += [check_coupling_grads(rows, rng, dev), check_coupling_grads(rows512, rng, dev),
                check_stft_frontend(dev, rng)] + check_conv(dev, rng)

    check_train_golden(cfg, dev)
    check_train_golden(cfg512, dev, GOLDEN_512, GOLDEN_512, (GRAD_LIMITS_512, LEAF_COSINE_512),
                       "train-golden-512")
    check_eval_512(cfg512, dev)
    check_eval_2048(cfg, dev)
    check_train_golden(cfg, dev, GOLDEN_GATED, GOLDEN, (GRAD_LIMITS_GATED, LEAF_COSINE_GATED),
                       "train-golden-gated", GATED)

    x_all = train_dataset(cfg, dev)
    common = ("cqt_project", "synth_render", "synth_backward")
    gated = ("coupling_grads", "stft_frontend", "conv1d_forward", "conv1d_weight")
    runs = {
        "SOT-2048 auto": train(cfg, dev, x_all, on=common + ("merge_coupling", "ref_grad_beta")),
        "SOT-512 auto": train(cfg512, dev, x_all,
                              on=common + ("merge_coupling", "sot_plane_backward")),
        "SOT-512-LogF auto": train(get_experiment("SOT-512-LogF"), dev, x_all, window=False,
                                   on=common + ("merge_coupling", "sot_plane_backward")),
        "SOT-2048 default": train(cfg, dev, x_all, kernels="default",
                                  on=common + ("sot_plane_forward", "sot_plane_backward")),
        "SOT-512 default": train(cfg512, dev, x_all, kernels="default", window=False,
                                 on=common + ("sot_plane_forward", "sot_plane_backward")),
        "SOT-2048 gated": train(cfg, dev, x_all, kernels=GATED,
                                on=common + ("merge_coupling",) + gated),
        "SOT-512 gated": train(cfg512, dev, x_all, kernels=GATED, window=False,
                               on=common + ("merge_coupling",) + gated),
        "SOT-2048 conv_bf16": train(cfg, dev, x_all, kernels=CONV_BF16, window=False,
                                    on=common + ("merge_coupling", "ref_grad_beta"),
                                    gates_name="auto+conv_bf16"),
    }
    conv_launches = (runs["SOT-2048 gated"]["conv1d_forward"],
                     runs["SOT-2048 gated"]["conv1d_weight"])
    require(conv_launches == (4 * TRAIN_STEPS, 2 * TRAIN_STEPS),
            f"the gated SOT-2048 steps launched kernels 10 / 11 {conv_launches} times, "
            f"expected {4 * TRAIN_STEPS} / {2 * TRAIN_STEPS}")
    conv_gate_ab(cfg, dev, x_all)
    check_train_run(dev, x_all=x_all)
    # each kernel's count from the run whose main path it is on (kernel 4 at
    # [1024, 257]: SOT-512 auto; kernels 6 and 7 at each loss shape: SOT-2048
    # default at [1024, 1026], SOT-512 default (6) and auto (7) at [1024, 258];
    # kernel 8 at [1024, 257]: SOT-512 gated)
    main_path = {("merge_coupling", "[1024, 257]"): "SOT-512 auto",
                 ("coupling_grads", "[1024, 1025]"): "SOT-2048 gated",
                 ("coupling_grads", "[1024, 257]"): "SOT-512 gated",
                 ("sot_plane_forward", "[1024, 1026]"): "SOT-2048 default",
                 ("sot_plane_backward", "[1024, 1026]"): "SOT-2048 default",
                 ("sot_plane_forward", "[1024, 258]"): "SOT-512 default",
                 ("sot_plane_backward", "[1024, 258]"): "SOT-512 auto",
                 **{(k, None): "SOT-2048 gated" for k in gated}}
    print(f"[serving] launches during the serving requests: {serving_launches}")
    for k in kernels:
        run = main_path.get((k["name"], k.get("shape")), "SOT-2048 auto")
        k["launches"] = runs[run][k["name"]]
        print(f"[timing] {k['name']}{' ' + k['shape'] if 'shape' in k else ''}: kernel "
              f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms'] if k['library_ms'] is None else round(k['library_ms'], 4)}"
              f" ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), {k['launches']} launches "
              f"over the {TRAIN_STEPS} {run} train steps | {card}")

    print(f"[profile] device busy ms: {json.dumps(BUSY_MS)} | {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
