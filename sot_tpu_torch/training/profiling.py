"""Profiling (port of ``sot_tpu/training/profiling.py``) on ``torch.profiler``.

``trace`` records a Kineto trace of the enclosed work into ``log_dir`` as a
gzipped Chrome trace (``*.pt.trace.json.gz``: chrome://tracing, Perfetto,
or TensorBoard's PyTorch profiler plugin); ``summarize_trace`` parses the
newest one into device ms per step by kernel name;
``summarize_trace_by_category`` into device ms per step by category, where
Kineto's device categories (``kernel``, ``gpu_memcpy``, ``gpu_memset``)
take the place of the JAX package's HLO categories and the ``kernel``
events are split by origin: the port's hand-written kernels (``csrc/``),
the libraries' (cuDNN, cuBLAS, cuFFT) and PyTorch's own.

A trace holds device events only where the profiler saw a device: on the
CPU it has none, and the summaries then say "not measured" rather than
print a zero. Kernels replayed from a CUDA graph are device events like
any other when the profiler records them.

``span(name)`` marks a stretch of the port's own host code in the trace
(one of ``SPANS``): a ``record_function`` while a profiler records, else a
shared no-op, so an untraced call pays one flag check. Kineto writes the
spans (``user_annotation``) and the device events into one trace, on one
clock; ``summarize_spans`` reads each span's host time and the device's
idle time inside it.
"""

from __future__ import annotations

import bisect
import collections
import glob
import gzip
import json
import os
import re
from contextlib import contextmanager, nullcontext
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# Kineto's categories of work that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_LIBRARY = re.compile(r"cudnn|cublas|cufft|fft|gemm|gemv|splitK|xmma|cutlass|winograd"
                      r"|implicit_convolve|dgrad|wgrad|^sm\d+_", re.IGNORECASE)
_PYTORCH = re.compile(r"at::|c10::|elementwise|reduce_kernel|vectorized|foreach")

# The port's spans, opened in ``training/trainer.py``. The benchmark's
# readers (``portbench/metrics/``) and ``summarize_spans`` find them by
# these names.
SPANS = (
    "sot.predict",            # predict(): one request, entry to return (CPU and GPU)
    "sot.predict.capture",    # a graph-cache miss: PredictGraph's warm-up and capture
    "sot.predict.copy_in",    # the request copied into the graph's input buffer
    "sot.predict.replay",     # the graph's replay and the launch counts
    "sot.predict.clone_out",  # the outputs cloned out of the graph's buffers
    "sot.train.chunk",        # TrainGraph's call: a chunk of updates
    "sot.train.upload",       # the chunk's offsets copied in (pageable: the queue drains)
    "sot.train.replays",      # the device step set, the replays and the launch counts
)

_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = nullcontext()


def span(name: str):
    """A span of the port's host code named ``name`` (one of ``SPANS``) in
    the trace of a running profiler; with none running, the one shared
    no-op context (nothing allocated, nothing recorded)."""
    return torch.profiler.record_function(name) if _profiling() else _NO_SPAN


@contextmanager
def trace(log_dir: str):
    """Record the enclosed work, host and (where there is one) GPU, into
    ``log_dir`` (parsable with ``summarize_trace``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir, use_gzip=True)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _load_events(log_dir: str) -> List[Dict]:
    """The complete events (``ph`` X, with a duration) of the newest trace."""
    files = sorted(glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json*"), recursive=True),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no .pt.trace.json under {log_dir}")
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as fh:
        doc = json.load(fh)
    return [e for e in doc.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]


def _load_device_events(log_dir: str) -> List[Dict]:
    return [e for e in _load_events(log_dir) if e.get("cat") in DEVICE_CATEGORIES]


@lru_cache(maxsize=1)
def handwritten_kernels() -> Tuple[str, ...]:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for src in sorted(_CSRC.glob("*.cu")):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                src.read_text()))
    return tuple(sorted(names))


@lru_cache(maxsize=None)
def kernel_origin(name: str) -> str:
    """Where a device kernel comes from, by its (demangled) name."""
    if any(re.search(rf"\b{k}\b", name) for k in handwritten_kernels()):
        return "csrc (hand-written)"
    if _LIBRARY.search(name):
        return "cuDNN/cuBLAS/cuFFT"
    if _PYTORCH.search(name):
        return "PyTorch"
    return "other"


def category(event: Dict) -> str:
    cat = event.get("cat", "?")
    return f"kernel: {kernel_origin(event.get('name', ''))}" if cat == "kernel" else cat


def summarize_trace(log_dir: str, top: int = 25, steps: int = 1) -> List[Tuple[str, float]]:
    """Device time by kernel name from the newest trace under ``log_dir``:
    [(name annotated with its category, ms per step)], most costly first;
    empty when the trace holds no device events."""
    totals: Dict[str, float] = collections.Counter()
    notes: Dict[str, str] = {}
    for e in _load_device_events(log_dir):
        name = e.get("name", "?")
        totals[name] += e["dur"]
        notes.setdefault(name, category(e))
    rows = [(f"[{notes[name]}] {name}", dur / (1e3 * steps)) for name, dur in totals.items()]
    rows.sort(key=lambda kv: -kv[1])
    return rows[:top]


def summarize_trace_by_category(log_dir: str, steps: int = 1) -> List[Tuple[str, float]]:
    """Device time by category (``kernel: <origin>``, ``gpu_memcpy``,
    ``gpu_memset``) in ms per step, most costly first; empty when the trace
    holds no device events."""
    totals: Dict[str, float] = collections.Counter()
    for e in _load_device_events(log_dir):
        totals[category(e)] += e["dur"]
    rows = [(cat, dur / (1e3 * steps)) for cat, dur in totals.items()]
    rows.sort(key=lambda kv: -kv[1])
    return rows


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize_spans(log_dir: str, steps: int = 1
                    ) -> List[Tuple[str, int, float, Optional[float]]]:
    """The port's spans (``SPANS``) in the newest trace under ``log_dir``:
    [(name, count, host ms per step, device-idle ms per step inside the
    spans)] in ``SPANS`` order, for the names the trace holds. Idle is a
    span's length less the union of the device's intervals inside it;
    None (not measured) when the trace holds no device events."""
    events = _load_events(log_dir)
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") in DEVICE_CATEGORIES])
    starts = [a for a, _ in busy]
    by_name: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in SPANS:
            by_name[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def idle(a: float, b: float) -> float:
        covered = 0.0
        for x, y in busy[max(0, bisect.bisect_right(starts, a) - 1):
                         bisect.bisect_left(starts, b)]:
            covered += max(0.0, min(y, b) - max(x, a))
        return b - a - covered

    rows = []
    for name in SPANS:
        spans = by_name.get(name)
        if spans:
            host = sum(b - a for a, b in spans) / (1e3 * steps)
            gap = sum(idle(a, b) for a, b in spans) / (1e3 * steps) if busy else None
            rows.append((name, len(spans), host, gap))
    return rows


def print_trace_summary(log_dir: str, steps: int = 1, top: int = 25) -> None:
    by_category = summarize_trace_by_category(log_dir, steps=steps)
    if not by_category:
        print("# the trace holds no device events: device time not measured")
    else:
        print("# by device category:")
        for cat, ms in by_category:
            if ms >= 0.005:
                print(f"{ms:8.3f} ms/step  {cat}")
        print("# top ops:")
        for name, ms in summarize_trace(log_dir, top=top, steps=steps):
            if ms >= 0.0005:
                print(f"{ms:8.3f} ms/step  {name[:140]}")
    spans = summarize_spans(log_dir, steps=steps)
    if spans:
        print("# program spans (count, host ms/step, device-idle ms/step inside):")
        for name, count, host, gap in spans:
            idle = "not measured" if gap is None else f"{gap:.3f}"
            print(f"{count:6d} {host:8.3f} {idle:>12}  {name}")
