"""The port's spans (``training/profiling.span``, opened in
``training/trainer.py``) and the benchmark's readers of them
(``portbench/metrics/``, through ``portbench/spans.py``):

  * with no profiler running, ``span`` is one shared no-op; under one, a
    ``record_function``;
  * the span names the trainer opens are ``profiling.SPANS``, and the
    readers read no other;
  * a CPU ``predict`` under ``profiling.trace`` writes one ``sot.predict``
    span around its body's ops, with none of the graph's parts;
  * the seven readers on hand-built traces with known answers, and None on
    a trace without the program's spans.

The tests marked ``cuda`` need the card (``python -m pytest
tests/test_torch_tracing.py -m cuda --noconftest``): each ``sot.predict``
part holds its runtime call, and ``sot.train.upload`` the stream
synchronise.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re

import numpy as np
import pytest
import torch

from portbench import spec
from portbench import trace as trace_lib
from sot_tpu_torch import data as tdata
from sot_tpu_torch.configs import get_experiment
from sot_tpu_torch.training import profiling
from sot_tpu_torch.training import trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_samples=1024, cqt_fmin=261.6, transform_n_fft=512, transform_hop=128,
            batch_size=8, dataset_size=32)
METRICS = ("predict_self_ms.serve", "predict_copy_in_ms.serve", "predict_replay_ms.serve",
           "predict_clone_ms.serve", "graph_hit_share.serve", "upload_idle_ms.train",
           "replay_idle_ms.train")


@pytest.fixture()
def card():
    """The CUDA device, or a skip where there is none (decided here, never
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph's spans exist only there)")
    return torch.device("cuda")


def _events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json.gz"))
    assert len(files) == 1
    with gzip.open(files[0], "rt") as fh:
        return [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]


def _spans(events, name):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == name)


def _within(events, cat, name, a, b):
    return [e for e in events if e.get("cat") == cat and e.get("name") == name
            and a <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= b]


# -- the span helper --------------------------------------------------------

def test_span_is_one_shared_noop_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    first, second = profiling.span("a"), profiling.span("b")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with first, second:  # reusable, and nestable in itself
        pass


def test_span_is_a_record_function_while_a_profiler_records():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = profiling.span("sot.predict")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(3).sum()
    assert profiling.span("a") is profiling.span("b")
    assert [e.name for e in prof.events() if e.name == "sot.predict"] == ["sot.predict"]


def test_span_names_are_the_documented_tuple():
    """Every span the trainer opens is in ``SPANS`` and each name of
    ``SPANS`` is opened; the readers name only spans of ``SPANS``."""
    assert all(name.startswith("sot.") for name in profiling.SPANS)
    with open(os.path.join(ROOT, "sot_tpu_torch/training/trainer.py")) as fh:
        opened = re.findall(r'span\("([^"]+)"\)', fh.read())
    assert sorted(set(opened)) == sorted(profiling.SPANS) and len(opened) == len(set(opened))
    read = set()
    for path in glob.glob(os.path.join(ROOT, "portbench/metrics/*.py")):
        with open(path) as fh:
            read.update(re.findall(r'"(sot\.[a-z_.]+)"', fh.read()))
    assert read and read <= set(profiling.SPANS)


def test_cpu_predict_writes_one_predict_span(tmp_path):
    cfg = get_experiment("SOT-2048", **TINY)
    mod = trainer.build_modules(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, cfg.n_samples)).astype(np.float32)
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        trainer.predict(mod, x)
    events = _events(log_dir)
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("sot.")]
    assert names == ["sot.predict"]
    (a, b), = _spans(events, "sot.predict")
    body = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert any(e["name"] == "aten::conv1d" for e in body)
    assert all(a <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= b for e in body)
    (name, count, host, idle), = profiling.summarize_spans(log_dir)
    assert (name, count, idle) == ("sot.predict", 1, None)
    assert host == pytest.approx((b - a) / 1e3)


# -- the readers on built traces --------------------------------------------

def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _window(kind, units, events):
    return trace_lib.Trace([_x("user_annotation", trace_lib.WINDOW, 0.0, 1000.0)] + events,
                           kind, units, 64, {})


def _serve_trace():
    """Three requests, the first a capture; one more opens after the window."""
    ua = "user_annotation"
    ev = []
    for unit, (pred, cap, copy, replay, clone) in zip(
            [(10, 200), (300, 200), (590, 200)],
            [((20, 100), (22, 38), (62, 8), (72, 20), (95, 15)),
             ((310, 50), None, (315, 6), (322, 20), (343, 10)),
             ((600, 100), None, (610, 30), (650, 10), (665, 25))]):
        ev.append(_x(ua, trace_lib.UNIT, *unit))
        ev.append(_x(ua, "sot.predict", *pred))
        for name, span in (("sot.predict.capture", cap), ("sot.predict.copy_in", copy),
                           ("sot.predict.replay", replay), ("sot.predict.clone_out", clone)):
            if span is not None:
                ev.append(_x(ua, name, *span))
        ev.append(_x("cpu_op", "aten::copy_", copy[0] + 1, copy[1] - 2))
        ev.append(_x("cuda_runtime", "cudaGraphLaunch", replay[0] + 1, replay[1] - 2))
        ev.append(_x("kernel", "conv", replay[0] + 5, 60.0))
    ev.append(_x(ua, "sot.predict", 1200.0, 50.0))  # after the window: not read
    ev.append(_x(ua, "sot.predict.capture", 1210.0, 20.0))
    ev.append(_x("gpu_user_annotation", "sot.predict.copy_in", 0.0, 900.0))  # the device's copy
    return _window("serve", 3, ev)


def _train_trace():
    """Two chunks of two steps: an upload the device partly drains into, and
    one that a long kernel covers; replays with overlapping kernels."""
    ua = "user_annotation"
    ev = [_x(ua, trace_lib.UNIT, 0.0, 950.0), _x(ua, "sot.train.chunk", 0.0, 805.0),
          _x(ua, "sot.train.upload", 10.0, 100.0), _x(ua, "sot.train.replays", 120.0, 680.0),
          _x(ua, "sot.train.chunk", 805.0, 100.0), _x(ua, "sot.train.upload", 810.0, 20.0),
          _x(ua, "sot.train.replays", 835.0, 60.0),
          _x("kernel", "step", 0.0, 50.0), _x("gpu_memcpy", "Memcpy HtoD", 100.0, 5.0),
          _x("cuda_runtime", "cudaStreamSynchronize", 12.0, 90.0),
          _x("kernel", "step", 130.0, 270.0), _x("kernel", "step", 390.0, 310.0),
          _x("kernel", "step", 750.0, 150.0),
          _x("gpu_user_annotation", "sot.train.upload", 0.0, 1000.0)]
    return _window("train", 4, ev)


# upload idle: (100 - 40 - 5) + (20 - 20) us; replays idle: (680 - 570 - 50)
# + (60 - 60) us; each over 4 steps
KNOWN = {
    "predict_self_ms.serve": ("serve", 0.019),       # median of 19, 14, 35 us
    "predict_copy_in_ms.serve": ("serve", 0.008),    # median of 8, 6, 30 us
    "predict_replay_ms.serve": ("serve", 0.020),     # median of 20, 20, 10 us
    "predict_clone_ms.serve": ("serve", 0.015),      # median of 15, 10, 25 us
    "graph_hit_share.serve": ("serve", 200.0 / 3),   # the first request captured
    "upload_idle_ms.train": ("train", 0.01375),
    "replay_idle_ms.train": ("train", 0.015),
}


@pytest.mark.parametrize("metric", METRICS)
def test_reader_on_a_built_trace(metric):
    kind, want = KNOWN[metric]
    read = spec.load_reader(metric)
    own, other = (_serve_trace(), _train_trace()) if kind == "serve" else \
        (_train_trace(), _serve_trace())
    assert read(own) == pytest.approx(want, rel=1e-12)
    assert read(other) is None


@pytest.mark.parametrize("metric", METRICS)
def test_reader_reads_none_without_the_program_spans(metric):
    """As on a program that opens no span: the harness's own spans and the
    device's work, and nothing of ``sot.*``."""
    kind = KNOWN[metric][0]
    ev = [_x("user_annotation", trace_lib.UNIT, 10.0, 400.0),
          _x("cpu_op", "aten::copy_", 20.0, 10.0),
          _x("cuda_runtime", "cudaGraphLaunch", 40.0, 100.0),
          _x("cuda_runtime", "cudaStreamSynchronize", 150.0, 100.0),
          _x("kernel", "conv", 60.0, 300.0)]
    assert spec.load_reader(metric)(_window(kind, 2, ev)) is None


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_predict_spans_hold_their_runtime_calls_on_card(card, tmp_path):
    cfg = get_experiment("SOT-2048", **TINY)
    mod = trainer.build_modules(cfg, device=card, generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, cfg.n_samples)).astype(np.float32)
    trainer.predict(mod, x)  # the capture, before the trace
    torch.cuda.synchronize()
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        for _ in range(3):
            {k: v.cpu() for k, v in trainer.predict(mod, x).items()}
    events = _events(log_dir)
    assert len(_spans(events, "sot.predict")) == 3
    assert _spans(events, "sot.predict.capture") == []
    for a, b in _spans(events, "sot.predict.replay"):
        assert len(_within(events, "cuda_runtime", "cudaGraphLaunch", a, b)) == 1
    copies = _spans(events, "sot.predict.copy_in")
    assert len(copies) == 3
    device = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]}
    for a, b in copies:
        calls = _within(events, "cuda_runtime", "cudaMemcpyAsync", a, b)
        assert calls
        assert all(device[c["args"]["correlation"]] >= a for c in calls)


@pytest.mark.cuda
def test_train_upload_span_holds_the_drain_on_card(card, tmp_path):
    cfg = get_experiment("SOT-2048", **TINY)
    x_all = torch.as_tensor(tdata.peak_normalize(
        tdata.dataset_from_config(cfg, device=card)["train"].x), dtype=torch.float32,
        device=card)
    mod = trainer.build_modules(cfg, device=card, generator=torch.Generator().manual_seed(0))
    state = trainer.init_state(mod)
    trainer.train_steps_graph(mod, state, x_all, [0])  # the capture, before the trace
    torch.cuda.synchronize()
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        trainer.train_steps_graph(mod, state, x_all, [0, 4, 8])
    events = _events(log_dir)
    (c0, c1), = _spans(events, "sot.train.chunk")
    uploads = _spans(events, "sot.train.upload")
    replays = _spans(events, "sot.train.replays")
    # the buffer holds an epoch's offsets: a longer chunk goes in pieces
    capacity = state.graph.capacity
    assert len(uploads) == len(replays) == -(-3 // capacity)
    launches = []
    for (u0, u1), (r0, r1) in zip(uploads, replays):
        assert c0 <= u0 < u1 <= r0 < r1 <= c1
        assert _within(events, "cuda_runtime", "cudaStreamSynchronize", u0, u1)
        launches.append(len(_within(events, "cuda_runtime", "cudaGraphLaunch", r0, r1)))
    assert launches == [min(capacity, 3 - i * capacity) for i in range(len(replays))]
