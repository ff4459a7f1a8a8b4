"""The program's own spans in the traced window, for the readers in
``metrics/``: host spans that ``sot_tpu_torch`` opens inside its serving
and training loops while the profiler records (``sot.predict`` and its
parts around ``trainer.PredictGraph``, ``sot.train.upload`` and
``sot.train.replays`` inside ``trainer.TrainGraph``). A program that opens
none leaves none in the trace, and the readers then read None."""

from __future__ import annotations

import statistics
from bisect import bisect_left, bisect_right
from typing import List, Optional, Sequence, Tuple

Span = Tuple[float, float]


def named(trace, name: str) -> List[Span]:
    """The (start, end) of every host span called ``name`` that opens in
    the window, in start order (microseconds on the trace's clock)."""
    return sorted((a, b) for n, a, b in trace.host if n == name and trace.w0 <= a <= trace.w1)


def inside(outer: Sequence[Span], inner: Sequence[Span]) -> List[List[Span]]:
    """For each span of ``outer``, the spans of ``inner`` (in start order)
    that lie within it."""
    starts = [a for a, _ in inner]
    return [[(x, y) for x, y in inner[bisect_left(starts, a):bisect_right(starts, b)] if y <= b]
            for a, b in outer]


def median_ms(trace, name: str) -> Optional[float]:
    """The median length of a serving window's ``name`` spans, in ms."""
    spans = named(trace, name)
    if trace.kind != "serve" or not spans:
        return None
    return statistics.median(b - a for a, b in spans) / 1e3


def idle_ms_per_step(trace, name: str) -> Optional[float]:
    """Device-idle ms inside a training window's ``name`` spans (each
    span's length less the device's busy time in it), over its steps."""
    spans = named(trace, name)
    if trace.kind != "train" or not spans or trace.units == 0:
        return None
    return sum(b - a - trace.busy_in(a, b) for a, b in spans) / 1e3 / trace.units
