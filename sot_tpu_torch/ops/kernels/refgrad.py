"""Reference-convention SOT gradient: hand-written CUDA kernel and its plain
version.

Replaces the TPU kernel ``sot_tpu/ops/pallas/refgrad.py:_refgrad_kernel``
(entry ``_refgrad_queries_pallas``, caller ``ref_grad_beta``). The CUDA
source is ``sot_tpu_torch/csrc/refgrad.cu``.

The beta cotangent of the same-grid W_2^2 loss with a constant target, in
the convention of the plane kernel (``sot_tpu/ops/pallas/sot.py:
_bwd_kernel``), which every real training row exercises at its cap-tie
kinks (PERF.md, "The gradient-convention lesson"). Per row, for each query
q = beta_j: the ranks R_lt = #{alpha < q} and R_le = #{alpha <= q} on the
RAW values, the payloads P^m = ne * g^m at those ranks, and the closed form
of ``_assemble`` (see ``sot_tpu/ops/pallas/refgrad.py`` for the derivation).

  * ``ref_grad_beta_plain`` — ``ref_grad_beta_xla``: searchsorted + gather
  * ``ref_grad_beta`` — the wrapper: plain on a CPU tensor, the kernel on a
    CUDA tensor (or raises)
  * the O(n^2) oracle is the plane backward's plain version,
    ``ops/kernels/plane.sot_plane_backward_plain``

alpha must be nondecreasing (a clipped CDF), as ``torch.searchsorted``
requires in the plain version; a row of alpha that is not is outside the
contract. beta may be in any order.

Bound on the H100: bytes (12.6 MB at [1024, 1026], ~3.8 us). A block of
256 threads per row, a warp on 32 neighbouring columns: a
column whose flags vne_j and vne_{j+1} are both 0 gets a zero; on the
others a binary search of alpha gives the ranks and the closed form keeps
every rounding of the plain version. The two agree under ``==`` (and
``torch.equal``) on the same inputs, bit for bit wherever the result is
not a zero; a zero may carry the other sign.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch
import torch.nn.functional as F

from sot_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel (plain-version calls are not counted).
launches = 0

_MAX_COLS = 16384


def _combine(q2, q1, q0, G):
    """sum_i w_i (g_i - G)^2 from the three payload-channel values."""
    return q2 - 2.0 * G * q1 + (G * G) * q0


def _payloads(alpha: torch.Tensor, g: torch.Tensor) -> List[torch.Tensor]:
    """P^m = ne * g^m, m = 0, 1, 2, with ne = [alpha_i > alpha_{i-1}]."""
    gamma = F.pad(alpha, (1, 0))[:, :-1]
    ne = (alpha > gamma).to(torch.float32)
    return [ne, ne * g[None, :], ne * (g * g)[None, :]]


def _assemble(f_hi: Sequence[torch.Tensor], f_lo: Sequence[torch.Tensor],
              tie: torch.Tensor, q: torch.Tensor, P: Sequence[torch.Tensor],
              g: torch.Tensor, gnext: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Unweighted dbeta columns from the rank queries at q = beta."""
    q_zero = (q == 0.0).to(torch.float32)
    p0 = [Pm[:, :1] for Pm in P]
    inner1 = [fh * (1.0 - 0.5 * tie) - q_zero * p for fh, p in zip(f_hi, p0)]
    inner2 = [0.5 * (fh + fl - q_zero * p) - 0.5 * fh * tie
              for fh, fl, p in zip(f_hi, f_lo, p0)]
    t1 = _combine(inner1[2], inner1[1], inner1[0], g)
    t2 = _combine(inner2[2], inner2[1], inner2[0], gnext)
    delta = F.pad(beta, (1, 0))[:, :-1]
    vne = (beta > delta).to(torch.float32)
    vne_next = torch.cat([vne[:, 1:], torch.zeros_like(vne[:, :1])], dim=-1)
    k = q.shape[1]
    return vne[:, :k] * t1 - vne_next[:, :k] * t2


def ref_grad_beta_plain(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor,
                        wbar: torch.Tensor) -> torch.Tensor:
    """Rank-query form of the plane backward's beta side in O(n log n)."""
    alpha, beta = alpha.contiguous(), beta.contiguous()
    P = _payloads(alpha, g)
    r_lt = torch.searchsorted(alpha, beta, right=False)
    r_le = torch.searchsorted(alpha, beta, right=True)
    tie = (r_le > r_lt).to(torch.float32)
    f_hi, f_lo = [], []
    for Pm in P:
        P_pad = F.pad(Pm, (0, 1))
        f_hi.append(torch.gather(P_pad, -1, r_lt))
        f_lo.append(torch.gather(P_pad, -1, r_le))
    gnext = torch.cat([g[1:], g[-1:]])
    db = _assemble(f_hi, f_lo, tie, beta, P, g[None, :], gnext[None, :], beta)
    return wbar[:, None] * db


def _bind() -> ctypes.CDLL:
    lib = _build.load("refgrad")
    fn = lib.refgrad_beta_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def ref_grad_beta(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor,
                  wbar: torch.Tensor) -> torch.Tensor:
    """Plane-convention beta cotangent [rows, n] of the per-row losses
    weighted by ``wbar`` [rows]; alpha, beta [rows, n] clipped augmented
    CDFs, g [n] the augmented grid."""
    if alpha.device.type == "cpu":
        return ref_grad_beta_plain(alpha, beta, g, wbar)
    dev = alpha.device
    if dev.type != "cuda" or any(t.device != dev for t in (beta, g, wbar)):
        raise ValueError(f"ref_grad_beta: tensors on {alpha.device} / {beta.device} / "
                         f"{g.device} / {wbar.device}")
    if not all(t.dtype == torch.float32 for t in (alpha, beta, g, wbar)):
        raise TypeError("ref_grad_beta: the CUDA kernel takes float32 inputs")
    rows, n = alpha.shape
    if (beta.shape != alpha.shape or g.shape != (n,) or wbar.shape != (rows,)
            or not 1 <= n <= _MAX_COLS):
        raise ValueError(f"ref_grad_beta: alpha, beta [rows, n <= {_MAX_COLS}], g [n], "
                         f"wbar [rows]; got {tuple(alpha.shape)} / {tuple(beta.shape)} / "
                         f"{tuple(g.shape)} / {tuple(wbar.shape)}")
    alpha, beta, g, wbar = (t.contiguous() for t in (alpha, beta, g, wbar))
    db = torch.empty_like(beta)
    err = _bind().refgrad_beta_f32(alpha.data_ptr(), beta.data_ptr(), g.data_ptr(),
                                   wbar.data_ptr(), db.data_ptr(), rows, n,
                                   torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "refgrad_beta_f32")
    global launches
    launches += 1
    return db
