"""SOT W2 coupling and its gradient: hand-written CUDA kernels and their
plain versions.

Replaces the TPU kernels ``sot_tpu/ops/pallas/merge.py:_fwd_kernel`` (entry
``_coupling_fwd_pallas``; kernel B4) and ``_grad_kernel`` (entry
``_coupling_grads_pallas``; kernel B8). The CUDA source is
``sot_tpu_torch/csrc/merge.cu``.

    S[r] = sum_{k,l} x_k x_l min(a[r,k], b[r,l])

with a = cap - alpha, b = cap - beta the nonincreasing complements of two
clipped CDFs and x >= 0 the grid deltas. ``sot_w2_merge`` adds the
marginal and linear terms around it to give W_2^2 per row (the same
quantity as ``sot_tpu/ops/pallas/merge.py:sot_w2_merge``, without the
shaved-column boundary terms: the kernel covers every column).

``coupling_grads`` gives dS/da and dS/db in the min-halving convention
(autograd of ``torch.minimum``: a tie a_k == b_l splits 1/2, 1/2), which
is the ``full`` route's and differs from the plane convention of the other
three routes at the cap-tie kinks by design (PERF.md, "The
gradient-convention lesson").

Bounds on the H100: bytes (the forward reads 8.4 MB at [1024, 1025],
~2.5 us; the gradient also writes db, ~3.8 us). The value: a block of
``THREADS_PER_ROW`` threads per row walks the merge path of a and b in
equal slices, one co-rank search each, every element's term x a PX[count]
in float64; a row that is not nonincreasing on either side
(``unsorted_rows``) is summed over all pairs. The gradient: a block of 128
threads per row, one binary search per distinct query of a warp's columns
(a second only past a tie), float64 prefix sums in shared memory
(``tests/test_torch_merge_grad_plan.py`` transcribes it). See the
source.

On a CPU tensor ``coupling`` and ``coupling_grads`` run their plain
versions; on a CUDA tensor they launch the kernel or raise. Neither has an
autograd of its own: the training loss wraps them in ``autograd.Function``s
(``ops/wasserstein.py``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from sot_tpu_torch.ops.kernels import _build
from sot_tpu_torch.ops.scan import prefix_sum

# Launches of the CUDA kernels (plain-version calls are not counted).
launches = 0        # the coupling value, kernel B4
grad_launches = 0   # the coupling gradient, kernel B8

_MAX_COLS = 8192
# threads of a block of the coupling value, which walks one row
THREADS_PER_ROW = 128
# cells of one dense chunk of the gradient's full scan (rows that are not sorted)
_CHUNK_CELLS = 1 << 22


def coupling_plain(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One descending sort of the 2m merged values with +x / 0 payloads,
    prefix sums X (a side) and Y (b side), and the integral form
    S = sum_i X_i Y_i (t_i - t_{i+1}) (``_sot_w2_sortmerge``)."""
    rows, m = a.shape
    vals = torch.cat([a, b], dim=-1)
    zeros = torch.zeros_like(x)
    wa = torch.cat([x, zeros]).expand(rows, 2 * m)
    wb = torch.cat([zeros, x]).expand(rows, 2 * m)
    t, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    X = prefix_sum(torch.gather(wa, -1, order), axis=-1)
    Y = prefix_sum(torch.gather(wb, -1, order), axis=-1)
    widths = t - torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], dim=-1)
    return torch.sum(X * Y * widths, dim=-1)


def unsorted_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[rows] bool: the rows the coupling value sums over all m x m pairs,
    where a or b is not nonincreasing or holds a NaN."""
    def bad(s):
        return ~(s[:, 1:] <= s[:, :-1]).all(-1) | torch.isnan(s[:, 0])
    return bad(a) | bad(b)


def _side_grad_plain(s: torch.Tensor, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x_l (sum_k x_k [s_k > q_l] + sum_k x_k [s_k >= q_l]) / 2 per row, in
    float64 and rounded once: rank queries into the nonincreasing rows of
    s, and a dense scan for rows that are not sorted."""
    x64 = x.to(torch.float64)
    px = F.pad(torch.cumsum(x64, 0), (1, 0))  # px[p] = sum_{k < p} x_k
    neg_s, neg_q = (-s).contiguous(), (-q).contiguous()  # ascending rows
    strict = px[torch.searchsorted(neg_s, neg_q, right=False)]  # #{s > q}
    incl = px[torch.searchsorted(neg_s, neg_q, right=True)]     # #{s >= q}
    unsorted = torch.nonzero((s[:, 1:] > s[:, :-1]).any(-1)).flatten().tolist()
    m = s.shape[1]
    step = max(1, _CHUNK_CELLS // (m * m))
    for lo in range(0, len(unsorted), step):
        rows = unsorted[lo:lo + step]
        ss, qq = s[rows][:, None, :], q[rows][:, :, None]
        strict[rows] = torch.sum(torch.where(ss > qq, x64, 0.0), dim=-1)
        incl[rows] = torch.sum(torch.where(ss >= qq, x64, 0.0), dim=-1)
    return (x64 * (0.5 * (strict + incl))).to(torch.float32)


def coupling_grads_plain(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                         alpha_grads: bool = True
                         ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(dS/da or None, dS/db) [rows, m] in the min-halving convention:

        dS/db_l = x_l (sum_k x_k [a_k > b_l] + 1/2 sum_k x_k [a_k == b_l])

    and the mirror for a; dS/da only with ``alpha_grads``."""
    db = _side_grad_plain(a, b, x)
    return (_side_grad_plain(b, a, x) if alpha_grads else None), db


def _bind() -> ctypes.CDLL:
    lib = _build.load("merge")
    fn = lib.coupling_forward_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grad = lib.coupling_grads_f32
    grad.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    grad.restype = ctypes.c_int
    return lib


def _check(what: str, a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> None:
    if a.device.type != "cuda" or b.device != a.device or x.device != a.device:
        raise ValueError(f"{what}: tensors on {a.device} / {b.device} / {x.device}")
    if not all(t.dtype == torch.float32 for t in (a, b, x)):
        raise TypeError(f"{what}: the CUDA kernel takes float32 inputs")
    rows, m = a.shape
    if b.shape != a.shape or x.shape != (m,) or not 1 <= m <= _MAX_COLS:
        raise ValueError(f"{what}: a, b [rows, m <= {_MAX_COLS}] and x [m]; got "
                         f"{tuple(a.shape)} / {tuple(b.shape)} / {tuple(x.shape)}")


def coupling(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[rows, m] complements a, b and [m] deltas x -> S [rows] (no autograd)."""
    if a.device.type == "cpu":
        return coupling_plain(a, b, x)
    _check("coupling", a, b, x)
    rows, m = a.shape
    a, b, x = a.contiguous(), b.contiguous(), x.contiguous()
    out = torch.empty((rows,), dtype=torch.float32, device=a.device)
    err = _bind().coupling_forward_f32(a.data_ptr(), b.data_ptr(), x.data_ptr(),
                                       out.data_ptr(), rows, m,
                                       torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "coupling_forward_f32")
    global launches
    launches += 1
    return out


def coupling_grads(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                   alpha_grads: bool = True
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(dS/da or None, dS/db) [rows, m] of S = sum x_k x_l min(a_k, b_l),
    min-halving at ties (``coupling_grads_plain``; no autograd)."""
    if a.device.type == "cpu":
        return coupling_grads_plain(a, b, x, alpha_grads)
    _check("coupling_grads", a, b, x)
    rows, m = a.shape
    a, b, x = a.contiguous(), b.contiguous(), x.contiguous()
    db = torch.empty_like(b)
    da = torch.empty_like(a) if alpha_grads else None
    err = _bind().coupling_grads_f32(a.data_ptr(), b.data_ptr(), x.data_ptr(),
                                     None if da is None else da.data_ptr(), db.data_ptr(),
                                     rows, m, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "coupling_grads_f32")
    global grad_launches
    grad_launches += 1
    return da, db


CouplingFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _coupling_of_bodies(alpha_body: torch.Tensor, beta_body: torch.Tensor, cap: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    return coupling(cap[:, None] - alpha_body, cap[:, None] - beta_body, x)


def sot_w2_merge(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor,
                 coupling_fn: CouplingFn = _coupling_of_bodies) -> torch.Tensor:
    """W_2^2 rows on a shared grid from the clipped augmented CDFs alpha,
    beta [rows, n_aug] and the augmented grid g [n_aug]:

        W = marg - 2 * (g_0^2 cap + g_0 sum_k x_k (a_k + b_k) + S),

    marg = sum_i (alpha_i - alpha_{i-1}) g_i^2 + the same for beta. The
    cancellation in W is why tolerances on it are stated relative to marg.
    ``coupling_fn(alpha_body, beta_body, cap, x)`` gives S (default: kernel
    B4, no autograd; the ``full`` route passes a differentiable one).
    """
    gamma = torch.nn.functional.pad(alpha, (1, 0))[:, :-1]
    delta = torch.nn.functional.pad(beta, (1, 0))[:, :-1]
    g2 = g * g
    marg = (alpha - gamma) @ g2 + (beta - delta) @ g2
    cap = alpha[:, -1]
    x = g[1:] - g[:-1]
    a = cap[:, None] - alpha[:, :-1]
    b = cap[:, None] - beta[:, :-1]
    S = coupling_fn(alpha[:, :-1], beta[:, :-1], cap, x)
    cross = (g[0] * g[0]) * cap + g[0] * (a @ x + b @ x) + S
    return marg - 2.0 * cross
