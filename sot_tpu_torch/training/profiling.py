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
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
from contextlib import contextmanager
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

# Kineto's categories of work that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_LIBRARY = re.compile(r"cudnn|cublas|cufft|fft|gemm|gemv|splitK|xmma|cutlass|winograd"
                      r"|implicit_convolve|dgrad|wgrad|^sm\d+_", re.IGNORECASE)
_PYTORCH = re.compile(r"at::|c10::|elementwise|reduce_kernel|vectorized|foreach")


@contextmanager
def trace(log_dir: str):
    """Record the enclosed work, host and (where there is one) GPU, into
    ``log_dir`` (parsable with ``summarize_trace``)."""
    import torch
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


def _load_device_events(log_dir: str) -> List[Dict]:
    files = sorted(glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json*"), recursive=True),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no .pt.trace.json under {log_dir}")
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as fh:
        doc = json.load(fh)
    return [e for e in doc.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATEGORIES]


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


def print_trace_summary(log_dir: str, steps: int = 1, top: int = 25) -> None:
    by_category = summarize_trace_by_category(log_dir, steps=steps)
    if not by_category:
        print("# the trace holds no device events: device time not measured")
        return
    print("# by device category:")
    for cat, ms in by_category:
        if ms >= 0.005:
            print(f"{ms:8.3f} ms/step  {cat}")
    print("# top ops:")
    for name, ms in summarize_trace(log_dir, top=top, steps=steps):
        if ms >= 0.0005:
            print(f"{ms:8.3f} ms/step  {name[:140]}")
