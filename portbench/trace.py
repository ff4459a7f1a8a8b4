"""The traced window: ``torch.profiler`` over a stretch of the cell's own
work, its Chrome trace read back into device intervals and host spans.

Device work is Kineto's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events (not ``gpu_user_annotation``, which spans kernels and the gaps
between them). Busy time is the union of their intervals inside the
window, whose bounds are the host span ``portbench.window`` that the
harness opens around the work; idle time is the rest of that span. Each
idle gap is named by the innermost host event running at its middle.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import tempfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "portbench.window"
UNIT = "portbench.unit"


class Trace:
    """What the per-layer readers read. Times are microseconds on the
    trace's clock, except ``window_s``."""

    def __init__(self, events: List[dict], kind: str, units: int, clips_per_unit: int,
                 config: dict):
        self.kind, self.units, self.clips_per_unit, self.config = kind, units, clips_per_unit, config
        win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' spans, not 1")
        self.w0 = float(win[0]["ts"])
        self.w1 = self.w0 + float(win[0]["dur"])
        self.window_s = (self.w1 - self.w0) / 1e6
        self.kernels: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
                a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
                a, b = max(a, self.w0), min(b, self.w1)
                if b > a:
                    self.kernels.append((e.get("name", "?"), a, b))
        self.host = [(e.get("name", "?"), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                     for e in events
                     if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES
                     and e.get("name") != WINDOW]
        self.unit_spans = sorted((a, b) for n, a, b in self.host if n == UNIT)
        self.busy_intervals = union([(a, b) for _, a, b in self.kernels])
        self.busy_us = sum(b - a for a, b in self.busy_intervals)

    def busy_in(self, a: float, b: float) -> float:
        """Device-busy microseconds inside [a, b]."""
        return sum(max(0.0, min(y, b) - max(x, a)) for x, y in self.busy_intervals)

    def kernel_us(self, match) -> float:
        """Summed microseconds of the device events whose name ``match``
        accepts (their own durations: kernels of one group do not overlap)."""
        return sum(b - a for n, a, b in self.kernels if match(n))

    def top_kernels(self, k: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for n, a, b in self.kernels:
            by[n] = by.get(n, 0.0) + (b - a)
        return [[n, us / 1e6] for n, us in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[Tuple[str, float]]:
        """Idle seconds in the window by the innermost host event at each
        gap's middle ("host: between ops" where none runs)."""
        by: Dict[str, float] = {}
        edges = [self.w0] + [t for iv in self.busy_intervals for t in iv] + [self.w1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        host = sorted((x, y, n) for n, x, y in self.host if n != UNIT)
        active: List[Tuple[float, float, str]] = []  # heap of (end, start, name)
        at = 0
        for a, b in gaps:  # in time order: a sweep over the host events
            mid = 0.5 * (a + b)
            while at < len(host) and host[at][0] <= mid:
                heapq.heappush(active, (host[at][1], host[at][0], host[at][2]))
                at += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            name = min(active, key=lambda e: e[0] - e[1])[2] if active else "host: between ops"
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n, s / 1e6] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


@contextlib.contextmanager
def profiled() -> Iterator[Dict[str, list]]:
    """Profile the enclosed work (host and device); on exit the Chrome
    trace's events are in the yielded dict under "events". The trace file
    goes to the run's temporary directory and is removed once read."""
    from torch.profiler import ProfilerActivity, profile

    result: Dict[str, list] = {}
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        yield result
        if card:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            result["events"] = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)


def span(name: str):
    """A host span in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def reduce(events: List[dict], kind: str, units: int, clips_per_unit: int, config: dict,
           readers: Dict[str, object]) -> Tuple[Dict[str, float], Dict[str, float], Optional[dict]]:
    """(per-layer metric values, device busy_s / window_s, breakdown)."""
    tr = Trace(events, kind, units, clips_per_unit, config)
    values = {}
    for name, read in readers.items():
        v = read(tr)
        if v is not None:
            values[name] = v
    device = {"busy_s": tr.busy_us / 1e6, "window_s": tr.window_s}
    breakdown = {"device_ops": tr.top_kernels(), "idle_gaps": tr.idle_gaps()}
    return values, device, breakdown
