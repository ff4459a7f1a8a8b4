"""SOT W2 coupling forward: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``sot_tpu/ops/pallas/merge.py:_fwd_kernel`` (entry
``_coupling_fwd_pallas``). The CUDA source is ``sot_tpu_torch/csrc/merge.cu``.

    S[r] = sum_{k,l} x_k x_l min(a[r,k], b[r,l])

with a = cap - alpha, b = cap - beta the nonincreasing complements of two
clipped CDFs and x >= 0 the grid deltas. ``sot_w2_merge`` adds the
marginal and linear terms around it to give W_2^2 per row (the same
quantity as ``sot_tpu/ops/pallas/merge.py:sot_w2_merge``, without the
shaved-column boundary terms: the kernel covers every column).

Bound on the H100: bytes (8.4 MB read at [1024, 1025], ~2.5 us). One block
per row, binary searches into the row's b with float64 prefix and suffix
sums in shared memory; see the source for the design notes.

On a CPU tensor ``coupling`` runs ``coupling_plain``; on a CUDA tensor it
launches the kernel or raises. The value is convention-free, so the
function has no gradient of its own: the training loss wraps it in an
``autograd.Function`` whose backward is the refgrad kernel
(``ops/wasserstein.py``).
"""

from __future__ import annotations

import ctypes

import torch

from sot_tpu_torch.ops.kernels import _build
from sot_tpu_torch.ops.scan import prefix_sum

# Launches of the CUDA kernel (plain-version calls are not counted).
launches = 0

_MAX_COLS = 8192


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


def _bind() -> ctypes.CDLL:
    lib = _build.load("merge")
    fn = lib.coupling_forward_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def coupling(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[rows, m] complements a, b and [m] deltas x -> S [rows] (no autograd)."""
    if a.device.type == "cpu":
        return coupling_plain(a, b, x)
    if a.device.type != "cuda" or b.device != a.device or x.device != a.device:
        raise ValueError(f"coupling: tensors on {a.device} / {b.device} / {x.device}")
    if not all(t.dtype == torch.float32 for t in (a, b, x)):
        raise TypeError("coupling: the CUDA kernel takes float32 inputs")
    rows, m = a.shape
    if b.shape != a.shape or x.shape != (m,) or not 1 <= m <= _MAX_COLS:
        raise ValueError(f"coupling: a, b [rows, m <= {_MAX_COLS}] and x [m]; got "
                         f"{tuple(a.shape)} / {tuple(b.shape)} / {tuple(x.shape)}")
    a, b, x = a.contiguous(), b.contiguous(), x.contiguous()
    out = torch.empty((rows,), dtype=torch.float32, device=a.device)
    err = _bind().coupling_forward_f32(a.data_ptr(), b.data_ptr(), x.data_ptr(),
                                       out.data_ptr(), rows, m,
                                       torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "coupling_forward_f32")
    global launches
    launches += 1
    return out


def sot_w2_merge(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """W_2^2 rows on a shared grid from the clipped augmented CDFs alpha,
    beta [rows, n_aug] and the augmented grid g [n_aug]:

        W = marg - 2 * (g_0^2 cap + g_0 sum_k x_k (a_k + b_k) + S),

    marg = sum_i (alpha_i - alpha_{i-1}) g_i^2 + the same for beta. The
    cancellation in W is why tolerances on it are stated relative to marg.
    """
    gamma = torch.nn.functional.pad(alpha, (1, 0))[:, :-1]
    delta = torch.nn.functional.pad(beta, (1, 0))[:, :-1]
    g2 = g * g
    marg = (alpha - gamma) @ g2 + (beta - delta) @ g2
    cap = alpha[:, -1]
    x = g[1:] - g[:-1]
    a = cap[:, None] - alpha[:, :-1]
    b = cap[:, None] - beta[:, :-1]
    S = coupling(a, b, x)
    cross = (g[0] * g[0]) * cap + g[0] * (a @ x + b @ x) + S
    return marg - 2.0 * cross
