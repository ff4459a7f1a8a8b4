"""Banded-plane SOT: hand-written CUDA kernels and their plain versions.

Replaces the TPU kernels ``sot_tpu/ops/pallas/sot.py:_fwd_kernel`` (entry
``_pallas_fwd``) and ``_bwd_kernel`` (entry ``_pallas_bwd``). The CUDA source
is ``sot_tpu_torch/csrc/plane.cu``.

Per row of the clipped augmented CDFs alpha, beta [rows, n] on the grid g
[n], with gamma, delta the CDFs shifted right by one (0 first):

    mu_ij = relu(min(alpha_i, beta_j) - max(gamma_i, delta_j))
    W     = sum_ij mu_ij |g_i - g_j|^p

and its cotangents in the plane kernel's convention (tie weights 1 / 0.5 /
0, the gamma/delta shift folded back onto alpha/beta), which every real
training row exercises at its cap-tie kinks (PERF.md, "The
gradient-convention lesson").

  * ``sot_plane_forward_plain`` / ``sot_plane_backward_plain`` — the dense
    O(n^2) forms, in row chunks (one [1024, 1026, 1026] f32 plane would be
    4.3 GB); each cell's f32 product rounded as in the kernel, the sums in
    float64 and rounded once
  * ``sot_plane_forward`` / ``sot_plane_backward`` — the wrappers: the plain
    version on a CPU tensor, the kernel on a CUDA tensor (or raise)
  * ``staircase`` / ``full_scan_rows`` — the merge path the kernels walk and
    the rows that take their full scan, for the bound and the tests

The kernels walk each sorted row's merge path of alpha and beta over its
nonempty intervals, on which every cell with mu > 0 lies (at most 2n - 1 of
them): a block of THREADS_PER_ROW threads per row lists the nonempty
intervals, cuts the path's positions into equal slices, finds each slice's
start with one co-rank search and joins the float64 sums of keys cut by a
slice boundary with a fixed-order segmented scan (see the source). Bound on
the H100: bytes (8.4 MB read by the forward at [1024, 1026], ~2.5 us; the
backward also writes dbeta, ~3.8 us). Whole columns a thread would run each
block at the pace of its longest column band (PERF.md §6).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sot_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernels (plain-version calls are not counted).
launches = 0           # forward, kernel 6
backward_launches = 0  # backward, kernel 7

_MAX_COLS = 8192
# the kernels' work unit (plane.cu: NT): a block of 128 threads walks one row
THREADS_PER_ROW = 128
# cells of one dense chunk of the plain versions
_CHUNK_CELLS = 1 << 23


def _dist_pow(d: torch.Tensor, p: float) -> torch.Tensor:
    """|d|^p (``sot_tpu/ops/pallas/sot.py:_grid_dist_pow``)."""
    if p == 2.0:
        return d * d
    if p == 1.0:
        return torch.abs(d)
    return torch.abs(d) ** p


def _prev(x: torch.Tensor) -> torch.Tensor:
    """x shifted right by one along the last axis, 0 first."""
    return F.pad(x, (1, 0))[:, :-1]


def _next(x: torch.Tensor) -> torch.Tensor:
    """x shifted left by one along the last axis, 0 last."""
    return F.pad(x, (0, 1))[:, 1:]


def _row_chunks(rows: int, n: int):
    step = max(1, _CHUNK_CELLS // (n * n))
    return [slice(lo, min(lo + step, rows)) for lo in range(0, rows, step)]


def sot_plane_forward_plain(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor,
                            p: float) -> torch.Tensor:
    """Dense sum_ij mu_ij |g_i - g_j|^p per row [rows] (``_sot_bilinear_xla``)."""
    rows, n = alpha.shape
    dist = _dist_pow(g[:, None] - g[None, :], p)
    out = []
    for s in _row_chunks(rows, n):
        a, b = alpha[s], beta[s]
        mu = torch.relu(torch.minimum(a[:, :, None], b[:, None, :])
                        - torch.maximum(_prev(a)[:, :, None], _prev(b)[:, None, :]))
        out.append(torch.sum((mu * dist).to(torch.float64), dim=(1, 2)).to(torch.float32))
    return torch.cat(out) if out else alpha.new_zeros((0,))


def sot_plane_backward_plain(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor,
                             p: float, wbar: torch.Tensor, alpha_grads: bool = True
                             ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(dalpha or None, dbeta) [rows, n]: the dense transcription of
    ``_bwd_kernel`` (``sot.py:180-197``) with the shift fold of
    ``_pallas_bwd`` (``sot.py:365-380``), any p."""
    rows, n = alpha.shape
    dist = _dist_pow(g[None, :] - g[:, None], p)[None]  # [1, i, j]
    da_out, db_out = [], []
    for s in _row_chunks(rows, n):
        a, b = alpha[s][:, :, None], beta[s][:, None, :]
        c, d = _prev(alpha[s])[:, :, None], _prev(beta[s])[:, None, :]
        m = (torch.minimum(a, b) > torch.maximum(c, d)).to(torch.float32)
        k = m * dist * wbar[s][:, None, None]
        wa = torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0))
        wc = torch.where(c > d, 1.0, torch.where(c == d, 0.5, 0.0))
        kw, kc = k * wa, k * wc
        db = torch.sum((k - kw).to(torch.float64), dim=1)
        dd = torch.sum((kc - k).to(torch.float64), dim=1)
        db_out.append((db + _next(dd)).to(torch.float32))
        if alpha_grads:
            da = torch.sum(kw.to(torch.float64), dim=2)
            dc = -torch.sum(kc.to(torch.float64), dim=2)
            da_out.append((da + _next(dc)).to(torch.float32))
    empty = alpha.new_zeros((0, n))
    db = torch.cat(db_out) if db_out else empty
    if not alpha_grads:
        return None, db
    return (torch.cat(da_out) if da_out else empty), db


def staircase(alpha: torch.Tensor, beta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i, j) [rows, na + nb + 1] int64: the merge path of each row's alpha
    [rows, na] and beta [rows, nb], the position on each diagonal k = i + j,
    stepping i where alpha_i <= beta_j (ties to alpha). On a sorted row every
    cell with mu > 0 lies on it."""
    rows, na = alpha.shape
    order = torch.sort(torch.cat([alpha, beta], 1), dim=1, stable=True).indices
    i = torch.cumsum((order < na).to(torch.int64), 1)
    i = torch.cat([i.new_zeros((rows, 1)), i], 1)
    return i, torch.arange(i.shape[1], device=alpha.device) - i


def full_scan_rows(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """[rows] bool: the rows whose alpha or beta is not nondecreasing (or
    holds a NaN), which the kernels scan in full."""
    def bad(x):
        return (~(x[:, 1:] >= x[:, :-1])).any(1) | torch.isnan(x[:, 0])
    return bad(alpha) | bad(beta)


def _bind() -> ctypes.CDLL:
    lib = _build.load("plane")
    fwd = lib.sot_plane_forward_f32
    fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p]
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.sot_plane_backward_f32
    bwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return lib


def _check(what: str, alpha, beta, g, wbar=None) -> None:
    tensors = (alpha, beta, g) + (() if wbar is None else (wbar,))
    dev = alpha.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on {' / '.join(str(t.device) for t in tensors)}")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError(f"{what}: the CUDA kernel takes float32 inputs")
    rows, n = alpha.shape
    if (beta.shape != alpha.shape or g.shape != (n,) or not 1 <= n <= _MAX_COLS
            or (wbar is not None and wbar.shape != (rows,))):
        raise ValueError(f"{what}: alpha, beta [rows, n <= {_MAX_COLS}], g [n], wbar [rows]; "
                         f"got {' / '.join(str(tuple(t.shape)) for t in tensors)}")


def sot_plane_forward(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor,
                      p: float = 2.0) -> torch.Tensor:
    """W_p^p per row [rows] (no autograd; ``ops/wasserstein.py`` wraps it)."""
    if alpha.device.type == "cpu":
        return sot_plane_forward_plain(alpha, beta, g, p)
    _check("sot_plane_forward", alpha, beta, g)
    alpha, beta, g = (t.contiguous() for t in (alpha, beta, g))
    rows, n = alpha.shape
    out = torch.empty((rows,), dtype=torch.float32, device=alpha.device)
    err = _bind().sot_plane_forward_f32(alpha.data_ptr(), beta.data_ptr(), g.data_ptr(),
                                        float(p), out.data_ptr(), rows, n,
                                        torch.cuda.current_stream(alpha.device).cuda_stream)
    _build.check(err, "sot_plane_forward_f32")
    global launches
    launches += 1
    return out


def sot_plane_backward(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor, p: float,
                       wbar: torch.Tensor, alpha_grads: bool = True
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(dalpha or None, dbeta) [rows, n] of the per-row losses weighted by
    ``wbar`` [rows]; dalpha only with ``alpha_grads``."""
    if alpha.device.type == "cpu":
        return sot_plane_backward_plain(alpha, beta, g, p, wbar, alpha_grads)
    _check("sot_plane_backward", alpha, beta, g, wbar)
    alpha, beta, g, wbar = (t.contiguous() for t in (alpha, beta, g, wbar))
    rows, n = alpha.shape
    db = torch.empty_like(beta)
    da = torch.empty_like(alpha) if alpha_grads else None
    err = _bind().sot_plane_backward_f32(
        alpha.data_ptr(), beta.data_ptr(), g.data_ptr(), wbar.data_ptr(), float(p),
        None if da is None else da.data_ptr(), db.data_ptr(), rows, n,
        torch.cuda.current_stream(alpha.device).cuda_stream)
    _build.check(err, "sot_plane_backward_f32")
    global backward_launches
    backward_launches += 1
    return da, db
