"""Observability (L9), port of ``sot_tpu/training/observability.py``: the
signal, spectrum and probability figures of each evaluation.

Figures are host work: the arrays of one logged batch are copied to the host
once (outside any captured graph), drawn with matplotlib's Agg backend
(imported at the first use, never at module import) and written as PNGs
under ``<out_dir>/figures/step<N>/``, with the JAX package's file names;
when a wandb run is active they are mirrored as wandb Images under the
reference's keys (``Signal_{step_name}/{name}``). Without matplotlib an
enabled ``FigureLogger`` raises at construction, naming it.

``plot_and_log`` draws the reference's gallery: original and reconstructed
signals and spectra, the time-averaged spectra on the transform's frequency
axis, and the pitch-probability curve with the ground truth as a vertical;
``log_quantiles`` the Wasserstein quantile functions.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Union

import numpy as np


def _wandb_run():
    try:  # wandb is optional everywhere in this framework
        import wandb

        return wandb.run
    except Exception:
        return None


def _plt():
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError(
            "the figure gallery (train --figures, train(figure_dir=...)) needs matplotlib, "
            "which is not installed") from exc

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


class FigureLogger:
    """Writes figures to ``<out_dir>/figures/step<N>/<key>.png`` (+ wandb)."""

    def __init__(self, out_dir: Optional[str], enabled: bool = True):
        self.out_dir = out_dir
        self.enabled = enabled and out_dir is not None
        if self.enabled:
            _plt()  # fail before a run, not at its first evaluation

    def _save(self, fig, step: int, key: str) -> None:
        if not self.enabled:
            return
        d = os.path.join(self.out_dir, "figures", f"step{step}")
        os.makedirs(d, exist_ok=True)
        safe = key.replace("/", "_").replace(" ", "_")
        fig.savefig(os.path.join(d, f"{safe}.png"), dpi=100,
                    bbox_inches="tight")
        run = _wandb_run()
        if run is not None:
            import wandb

            run.log({key: wandb.Image(fig)}, step=step)

    def log_signal(self, step: int, step_name: str, name: str,
                   signal: np.ndarray, x_values: Optional[np.ndarray] = None,
                   sample: int = 0) -> None:
        """1D line plot of signal[sample]."""
        if not self.enabled:
            return
        plt = _plt()
        y = np.asarray(signal)
        if y.ndim == 3:
            y = y[sample]
        elif y.ndim == 2:
            y = y[sample : sample + 1]
        fig = plt.figure(figsize=(8, 4))
        for row in np.atleast_2d(y):
            if x_values is not None:
                plt.plot(np.asarray(x_values), row)
            else:
                plt.plot(row)
        plt.title(name)
        self._save(fig, step, f"Signal_{step_name}/{name}")
        plt.close(fig)

    def log_signals(self, step: int, step_name: str, name: str,
                    signals: Dict[str, np.ndarray],
                    x_values: Optional[np.ndarray] = None,
                    sample: int = 0) -> None:
        """Overlay of labelled 1D signals."""
        if not self.enabled:
            return
        plt = _plt()
        fig = plt.figure(figsize=(8, 4))
        for label, sig in signals.items():
            y = np.asarray(sig)
            while y.ndim > 1:
                y = y[sample] if y.shape[0] > sample else y[0]
            if x_values is not None:
                plt.plot(np.asarray(x_values), y, label=label)
            else:
                plt.plot(y, label=label)
        plt.legend()
        plt.title(name)
        self._save(fig, step, f"Signal_{step_name}/{name}")
        plt.close(fig)

    def log_quantiles(self, step: int, step_name: str,
                      qs: np.ndarray, u_quantiles: np.ndarray,
                      v_quantiles: np.ndarray, sample: int = 0) -> None:
        """Wasserstein quantile-function figure, from
        ``Wasserstein1D(..., return_quantiles=True)``. Left: both quantile
        functions Q_u / Q_v over the quantile level (the area between them is
        the W1 transport cost). Right: their pointwise displacement
        Q_u - Q_v."""
        if not self.enabled:
            return
        plt = _plt()

        def row(a):
            a = np.asarray(a)
            while a.ndim > 1:
                a = a[sample] if a.shape[0] > sample else a[0]
            return a

        q, uq, vq = row(qs), row(u_quantiles), row(v_quantiles)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
        ax1.plot(q, uq, label="Original $Q_u$")
        ax1.plot(q, vq, label="Reconstructed $Q_v$")
        ax1.fill_between(q, uq, vq, alpha=0.2)
        ax1.set_xlabel("quantile level")
        ax1.set_ylabel("position (unit frequency)")
        ax1.legend()
        ax2.plot(q, uq - vq)
        ax2.axhline(0.0, color="k", lw=0.5)
        ax2.set_xlabel("quantile level")
        ax2.set_ylabel("$Q_u - Q_v$")
        fig.suptitle("Wasserstein quantile functions")
        self._save(fig, step, f"Signal_{step_name}/Quantile Functions")
        plt.close(fig)

    def log_histogram(self, step: int, step_name: str, name: str,
                      values: np.ndarray,
                      x_values: Optional[np.ndarray] = None,
                      vertical_line: Optional[Union[float, Sequence]] = None,
                      sample: int = 0) -> None:
        """Probability-vector plot with optional ground-truth verticals."""
        if not self.enabled:
            return
        plt = _plt()
        y = np.asarray(values)
        while y.ndim > 1:
            y = y[sample] if y.shape[0] > sample else y[0]
        fig = plt.figure(figsize=(8, 4))
        xs = np.asarray(x_values) if x_values is not None else np.arange(len(y))
        plt.plot(xs, y)
        if vertical_line is not None:
            for v in np.atleast_1d(np.asarray(vertical_line, np.float64)).ravel()[:8]:
                plt.axvline(float(v), color="r", linestyle="--", alpha=0.6)
        plt.title(name)
        self._save(fig, step, f"Signal_{step_name}/{name}")
        plt.close(fig)

    def plot_spectrogram(self, step: int, step_name: str, name: str,
                         spec: np.ndarray, sample: int = 0) -> None:
        """Log-magnitude image of a (frames, bins) spectrogram."""
        if not self.enabled:
            return
        plt = _plt()
        s = np.asarray(spec)
        if s.ndim == 3:
            s = s[sample]
        fig = plt.figure(figsize=(8, 4))
        plt.imshow(np.log(np.abs(s.T) + 1e-7), origin="lower", aspect="auto",
                   cmap="magma")
        plt.colorbar()
        plt.title(name)
        self._save(fig, step, f"Signal_{step_name}/{name}")
        plt.close(fig)

    def plot_and_log(self, step: int, step_name: str, outputs: Dict,
                     transform_frequencies: Optional[np.ndarray] = None,
                     feature_frequencies: Optional[np.ndarray] = None,
                     sample: int = 0) -> None:
        """The gallery of one evaluation.

        outputs: host numpy copies of {x, x_hat, spec_x, spec_x_hat,
        probabilities?, true_frequency_unit?, gain?, loudness?}.
        """
        if not self.enabled:
            return
        get = outputs.get
        if get("x") is not None:
            self.log_signal(step, step_name, "Original Signal", get("x"),
                            sample=sample)
        if get("x_hat") is not None:
            self.log_signal(step, step_name, "Reconstructed Signal",
                            get("x_hat"), sample=sample)
        spec_x, spec_x_hat = get("spec_x"), get("spec_x_hat")
        if spec_x is not None and spec_x_hat is not None and spec_x.ndim >= 2:
            self.plot_spectrogram(step, step_name, "Original Spectrum",
                                  spec_x, sample=sample)
            self.plot_spectrogram(step, step_name, "Reconstructed Spectrum",
                                  spec_x_hat, sample=sample)
            red_x = np.asarray(spec_x)[sample].mean(axis=0)
            red_xh = np.asarray(spec_x_hat)[sample].mean(axis=0)
            self.log_signals(
                step, step_name, "Original vs Reconstructed",
                {"Original": red_x, "Reconstructed": red_xh},
                x_values=transform_frequencies)
        probs = get("probabilities")
        if probs is not None:
            p = np.asarray(probs)
            true_unit = get("true_frequency_unit")
            vline = None
            if true_unit is not None and feature_frequencies is not None:
                # unit in [0,1] -> index position on the feature axis
                u = float(np.asarray(true_unit).ravel()[sample]
                          if np.asarray(true_unit).size > sample
                          else np.asarray(true_unit).ravel()[0])
                vline = feature_frequencies[
                    int(round(u * (len(feature_frequencies) - 1)))]
            self.log_histogram(step, step_name, "Probabilities", p,
                               x_values=feature_frequencies,
                               vertical_line=vline, sample=sample)
        for key in ("gain", "loudness"):
            if get(key) is not None:
                self.log_signal(step, step_name, key.capitalize(), get(key),
                                sample=sample)
