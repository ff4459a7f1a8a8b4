"""The comparison that decides ``correct``, its model-independent parts:
the gaps between the program's numbers and the reference's, and the
verdict of the readings against a cell's limits. What a model's train and
serve checks read is ``compare/<model>.py``'s (the model its configuration
file names); PERF.md section 2 gives each limit and the readings it was
set from.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

Readings = Dict[str, float]


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> List[float]:
    """Per leaf: | |got| - |ref| | / max(|ref|, median leaf |ref|)."""
    g = {k: float(torch.linalg.vector_norm(got[k].double())) for k in keep}
    r = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    med = float(np.median(list(r.values())))
    return [abs(g[k] - r[k]) / max(r[k], med, 1e-30) for k in keep]


def whole_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """|got - ref| / |ref| over all leaves as one vector."""
    d = sum(float(torch.sum((got[k].double() - ref[k].double()) ** 2)) for k in ref)
    n = sum(float(torch.sum(ref[k].double() ** 2)) for k in ref)
    return (d / n) ** 0.5


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """|got - ref| / |ref|."""
    return float((got.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-30))


def max_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|."""
    return float(torch.max(torch.abs(got.double() - ref.double())) / torch.max(torch.abs(ref.double())))


def verdict(readings: Readings, limits: Dict[str, float]) -> bool:
    """Every number that has a limit at or below it (a NaN fails)."""
    missing = set(limits) - set(readings)
    if missing:
        raise ValueError(f"no reading for the limits {sorted(missing)}")
    return all(readings[k] <= limits[k] for k in limits)
