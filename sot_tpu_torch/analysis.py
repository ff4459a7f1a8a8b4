"""Pitch-error analysis: where and how a trained model fails.

The aggregate RPA/RCA numbers hide the structure of unsupervised pitch
errors (this task fails bimodally: most clips are estimated within a few
cents, a minority lock onto a wrong harmonic interpretation clip-wide).
``pitch_error_report`` breaks accuracy down per frame position, per f0
band, and classifies errors (octave up/down, fifth, other), which is how
round-1 established that the 2026 model's failures are clip-level local
minima rather than frame-edge artefacts.

CLI: ``python -m sot_tpu_torch.cli analyze --ckpt <checkpoint> [--experiment ...]``
(a copy of ``sot_tpu/analysis.py``, which is numpy only).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def pitch_error_report(pitch_hz: np.ndarray, true_f0: np.ndarray,
                       tolerance_cents: float = 50.0) -> Dict:
    """Structure of pitch errors.

    Args:
      pitch_hz: [n, frames] per-frame estimates.
      true_f0: [n] ground-truth f0 per clip.
    Returns a dict with per-frame RPA, per-f0-band stats, and an error-type
    histogram over clips whose median estimate is wrong.
    """
    pitch_hz = np.asarray(pitch_hz, np.float64)
    true_f0 = np.asarray(true_f0, np.float64).reshape(-1)
    cents = 1200.0 * np.log2(np.maximum(pitch_hz, 1e-6) / true_f0[:, None])
    ok = np.abs(cents) < tolerance_cents

    report: Dict = {
        "rpa": float(ok.mean()),
        "rpa_per_frame": ok.mean(axis=0).round(4).tolist(),
    }

    bands = [(40, 80), (80, 160), (160, 320), (320, 640), (640, 1280),
             (1280, 4000)]
    per_band = {}
    for lo, hi in bands:
        m = (true_f0 >= lo) & (true_f0 < hi)
        if m.sum():
            per_band[f"{lo}-{hi}Hz"] = {
                "n": int(m.sum()),
                "rpa": round(float(ok[m].mean()), 4),
                "median_abs_cents": round(float(np.median(np.abs(cents[m]))), 2),
            }
    report["per_f0_band"] = per_band

    # classify clips by their median estimate
    med_cents = np.median(cents, axis=1)
    wrong = np.abs(med_cents) >= tolerance_cents
    kinds = {"octave_up": 0, "octave_down": 0, "fifth": 0, "other": 0}
    for c in med_cents[wrong]:
        if abs(c - 1200) < tolerance_cents:
            kinds["octave_up"] += 1
        elif abs(c + 1200) < tolerance_cents:
            kinds["octave_down"] += 1
        elif abs(abs(c) - 702) < tolerance_cents or abs(abs(c) - 498) < tolerance_cents:
            kinds["fifth"] += 1
        else:
            kinds["other"] += 1
    report["clip_failures"] = {
        "n_wrong_clips": int(wrong.sum()),
        "n_clips": int(len(true_f0)),
        "kinds": kinds,
        # raw material for choosing correction candidates: the median error
        # of every wrong clip, in cents (e.g. +1902 = 3x, -702 = down a
        # fifth), sorted
        "wrong_clip_median_cents": sorted(
            round(float(c), 1) for c in med_cents[wrong]),
    }
    return report
