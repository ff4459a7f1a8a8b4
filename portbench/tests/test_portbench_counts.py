"""Operation and byte counts against hand counts, and the trace reduction
on a made-up trace."""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

import pytest

from portbench import counts, spec
from portbench.counts import pesto_sot
from portbench import trace as trace_lib

ROOT = Path(__file__).resolve().parents[2]
SOT = json.loads((ROOT / "portbench/configs/sot2048.json").read_text())
LIN = json.loads((ROOT / "portbench/configs/msslin.json").read_text())


def test_shapes():
    assert pesto_sot.n_bins(SOT) == 285 and pesto_sot.frames_per_clip(SOT) == 16


def test_the_40_to_40_conv():
    """One 40 -> 40, k = 15 conv forward at [1024, 40, 285]:
    2 * 40 * 40 * 15 * 285 * 1024 = 14.00832 GFLOP, 0.209 ms at the FP32
    cores' 67 TFLOP/s (PERF.md section 6, row 10), 28.3 us at TF32's 495."""
    flops = counts.conv_flops(40, 40, 15, 285, 1024)
    assert flops == 2 * 40 * 40 * 15 * 285 * 1024 == 14_008_320_000
    assert flops / 67e12 * 1e3 == pytest.approx(0.2091, abs=1e-4)
    nbytes = counts.conv_bytes(40, 40, 15, 285, 1024, "fwd")
    assert nbytes == 4 * (2 * 1024 * 40 * 285 + 40 * 40 * 15)
    assert counts.least_seconds(flops, nbytes) == pytest.approx(flops / 495e12)


def test_encoder_and_step_counts():
    rows = 1024
    convs = (2 * rows * 285 * (1 * 40 * 15 + 40 * 40 * 15 + 40 * 30 + 30 * 30 + 30 * 10 + 10 * 3))
    heads = 2 * rows * 855 * (285 + 20)
    cqt = pesto_sot.cqt_flops(SOT, 64)
    assert pesto_sot.forward_flops(SOT, 64) == cqt + convs + heads
    first = 2 * rows * 285 * 1 * 40 * 15
    assert pesto_sot.train_step_flops(SOT, 64) == cqt + 3 * (convs + heads) - first
    assert pesto_sot.train_step_flops(LIN, 64) == pesto_sot.train_step_flops(SOT, 64)


def test_cqt_support():
    """Each bin's kernel has ceil(Q sr / f_k) taps (Q = 1 / (2^(1/36) - 1)):
    25,169 for the first bin at 32.7 Hz; real and imaginary parts, two
    operations a tap, 16 frames a clip."""
    q = 1.0 / (2.0 ** (1.0 / 36) - 1.0)
    taps = sum(math.ceil(q * 16000 / (32.7 * 2.0 ** (k / 36))) for k in range(285))
    assert math.ceil(q * 16000 / 32.7) == 25169
    assert pesto_sot.cqt_flops(SOT, 1) == 2 * 2 * taps * 16


def test_w2_bytes_match_the_bound():
    """PERF.md section 6, rows 6-7: 8.4 MB read by the value at
    [1024, 1026] (0.0025 ms at 3.35 TB/s); the gradient also writes the
    value side's cotangent (0.0038 ms)."""
    value, grad = _metric_module("w2_roofline").w2_bytes(SOT)
    assert value == 4 * (2 * 1024 * 1026 + 1026 + 1024)
    assert grad == 4 * (3 * 1024 * 1026 + 1026 + 1024)
    assert value / 3.35e12 * 1e3 == pytest.approx(0.0025, abs=5e-5)
    assert grad / 3.35e12 * 1e3 == pytest.approx(0.0038, abs=5e-5)


def _metric_module(name):
    """A reader's file as a module, for its own arithmetic."""
    s = importlib.util.spec_from_file_location(name, ROOT / "portbench/metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _trace(kind="train", units=2):
    """A 100 us window: kernels at [10, 30] and [20, 40] (overlapping) and
    [60, 70]; a unit span [0, 50] and one [50, 100]; a host launch in
    [40, 60]."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace_lib.WINDOW, "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "wgrad_alg0_engine", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "plane_fwd_kernel", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 10},
          {"ph": "X", "cat": "user_annotation", "name": trace_lib.UNIT, "ts": 0, "dur": 50},
          {"ph": "X", "cat": "user_annotation", "name": trace_lib.UNIT, "ts": 50, "dur": 50},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 40, "dur": 20}]
    return trace_lib.Trace(ev, kind, units, 64, SOT)


def test_trace_union_and_gaps():
    tr = _trace()
    assert tr.busy_us == 40.0 and tr.window_s == 1e-4
    assert tr.busy_in(0, 50) == 30.0
    gaps = dict(tr.idle_gaps())
    assert gaps["cudaGraphLaunch"] == pytest.approx(20e-6)
    assert gaps["host: between ops"] == pytest.approx(40e-6)
    assert tr.kernel_us(lambda n: "plane" in n) == 20.0


@pytest.mark.parametrize("name, kind, expected", [
    ("step_busy_ms.train", "train", 40.0 / 1e3 / 2),
    ("idle_share.train", "train", 60.0),
    ("idle_share.serve", "serve", 60.0),
    ("request_busy_ms.serve", "serve", 40.0 / 1e3 / 2),
    ("request_overhead_ms.serve", "serve", ((50 - 30) + (50 - 10)) / 2 / 1e3),
    ("mfu.train", "train", 100.0 * pesto_sot.train_step_flops(SOT, 64) * 2 / 1e-4 / 495e12),
    ("mfu.serve", "serve", 100.0 * pesto_sot.forward_flops(SOT, 64) * 2 / 1e-4 / 495e12),
])
def test_readers(name, kind, expected):
    assert spec.load_reader(name)(_trace(kind)) == pytest.approx(expected)


@pytest.mark.parametrize("name", ["step_busy_ms.train", "idle_share.train", "mfu.train",
                                  "conv_roofline", "w2_roofline"])
def test_train_readers_read_nothing_in_a_serving_trace(name):
    assert spec.load_reader(name)(_trace("serve")) is None


def test_rooflines():
    tr = _trace("train", units=2)
    conv = spec.load_reader("conv_roofline")(tr)
    w2 = spec.load_reader("w2_roofline")(tr)
    mod = _metric_module("conv_roofline")
    assert conv == pytest.approx(100.0 * mod.least_step_seconds(SOT) * 2 / 20e-6)
    assert w2 == pytest.approx(100.0 * (8413192 + 12615688) / 3.35e12 * 2 / 20e-6)
    assert mod.is_conv("void cudnn::detail::dgrad_engine<float, 512>")
    assert not mod.is_conv("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_cublas")
