"""Analysis windows, computed host-side with scipy-parity coefficients.

The SOT experiments use scipy's periodic (fftbins=True) windows — flattop for
the loss-domain STFT (reference features.py:93-95 + SOT-2048 config) and the
periodic hann everywhere else (torch.hann_window default). We generate them
host-side at trace time (shapes are static), so there is no runtime cost.
"""

from __future__ import annotations

import numpy as np

# scipy.signal.windows.flattop coefficients (5-term cosine sum).
_FLATTOP_COEFFS = np.array(
    [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
)


def _general_cosine(n: int, coeffs: np.ndarray, periodic: bool = True) -> np.ndarray:
    m = n + 1 if periodic else n
    fac = np.linspace(-np.pi, np.pi, m)
    w = np.zeros(m)
    for k, a in enumerate(coeffs):
        w += a * np.cos(k * fac)
    return w[:-1] if periodic else w


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    """Periodic hann: 0.5*(1-cos(2*pi*k/n)) — torch.hann_window parity.

    Returns NUMPY (static trace-time metadata): inside jit a jnp constant
    would be a tracer, breaking np consumers like the FIR window assembly.
    """
    return _general_cosine(n, np.array([0.5, 0.5]), periodic).astype(np.float32)


def flattop_window(n: int, periodic: bool = True) -> np.ndarray:
    """scipy.signal.get_window('flattop', n) parity (fftbins=True)."""
    return _general_cosine(n, _FLATTOP_COEFFS, periodic).astype(np.float32)


def get_window(name: str, n: int, periodic: bool = True) -> np.ndarray:
    """Window factory mirroring scipy.signal.get_window for the names used here."""
    if name in ("hann", "hanning"):
        return hann_window(n, periodic)
    if name == "flattop":
        return flattop_window(n, periodic)
    raise ValueError(f"Unknown window: {name}")
