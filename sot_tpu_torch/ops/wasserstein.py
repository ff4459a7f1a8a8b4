"""1D Wasserstein distance, spectral optimal transport (``sot_tpu/ops/
wasserstein.py`` and the same-grid entry of ``sot_tpu/ops/pallas/sot.py``).

  * ``wasserstein_1d`` — the general closed form by quantile matching
    (sort -> cumsum -> merged quantile grid -> searchsorted lookups), plain
    PyTorch; gradients flow through the sorted weights and the gathered
    values, as in the reference
  * ``wasserstein_same_grid`` — both spectra on one shared sorted grid (the
    training hot path): CDFs, the quantile cap, the augmented tail lane,
    then the p = 1 closed form or, for p = 2 with a constant target, the
    merge-coupling value (kernel B4) with the reference-convention
    gradient (kernel B5) as one ``autograd.Function``
  * ``_sot_bilinear_xla`` — the dense O(n^2) overlap form, a test oracle

The same-grid path covers what the SOT-2048 train step runs. Other p, and a
target that needs a gradient, go through the banded-plane kernels
(``sot_tpu/ops/pallas/sot.py`` _fwd_kernel / _bwd_kernel), which are not
ported yet: they raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sot_tpu_torch.ops.kernels.merge import sot_w2_merge
from sot_tpu_torch.ops.kernels.refgrad import ref_grad_beta
from sot_tpu_torch.ops.scan import prefix_sum


def _grid_dist_pow(d: torch.Tensor, p: float) -> torch.Tensor:
    if p == 2.0:
        return d * d
    if p == 1.0:
        return torch.abs(d)
    return torch.abs(d) ** p


def _sot_bilinear_xla(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor,
                      p: float) -> torch.Tensor:
    """Dense sum_ij relu(min(a_i, b_j) - max(a_{i-1}, b_{j-1})) |g_i - g_j|^p."""
    gamma = F.pad(alpha, (1, 0))[:, :-1]
    delta = F.pad(beta, (1, 0))[:, :-1]
    mu = torch.relu(torch.minimum(alpha[:, :, None], beta[:, None, :])
                    - torch.maximum(gamma[:, :, None], delta[:, None, :]))
    dist = _grid_dist_pow(g[:, None] - g[None, :], p)
    return torch.sum(mu * dist[None], dim=(1, 2))


class _W2MergeRef(torch.autograd.Function):
    """W_2^2 rows: merge-coupling forward, reference-convention backward for
    beta; the target side (alpha) gets no cotangent (``_w2_merge_refbwd``)."""

    @staticmethod
    def forward(ctx, alpha, beta, g):
        ctx.save_for_backward(alpha, beta, g)
        return sot_w2_merge(alpha, beta, g)

    @staticmethod
    def backward(ctx, wbar):
        alpha, beta, g = ctx.saved_tensors
        return None, ref_grad_beta(alpha, beta, g, wbar.contiguous()), None


def clipped_cdfs(grid: torch.Tensor, u_weights: torch.Tensor, v_weights: torch.Tensor,
                 limit_quantile_range: bool = False):
    """(alpha, beta, gaug): the CDFs of the weight rows [rows, n] clipped at
    the cap, each with one virtual tail lane at the cap (quantile lookups
    past the grid end clamp to the last bin), and the grid [n] with its
    last point repeated. The cap is the largest CDF value <= 1 with
    ``limit_quantile_range``, else the larger total mass."""
    grid = grid.to(torch.float32)
    U = prefix_sum(u_weights.to(torch.float32), axis=-1)
    V = prefix_sum(v_weights.to(torch.float32), axis=-1)
    zero = torch.zeros((), dtype=U.dtype, device=U.device)
    if limit_quantile_range:
        # amax splits its gradient evenly among tied maxima and maximum
        # splits 0.5/0.5, as jnp.max and lax.max do
        cap = torch.maximum(torch.amax(torch.where(U <= 1.0, U, zero), dim=-1),
                            torch.amax(torch.where(V <= 1.0, V, zero), dim=-1))[:, None]
    else:
        cap = torch.maximum(U[:, -1], V[:, -1])[:, None]
    alpha = torch.cat([torch.minimum(U, cap), cap], dim=-1)
    beta = torch.cat([torch.minimum(V, cap), cap], dim=-1)
    return alpha, beta, torch.cat([grid, grid[-1:]])


def wasserstein_same_grid(grid: torch.Tensor, u_weights: torch.Tensor,
                          v_weights: torch.Tensor, p: float = 2.0,
                          limit_quantile_range: bool = False,
                          target_constant: bool = False) -> torch.Tensor:
    """W_p^p between weight rows [rows, n] on one shared sorted grid [n] ->
    [rows]. ``limit_quantile_range`` integrates quantile levels up to the
    largest CDF value <= 1 (the paper's frequency cutoff)."""
    if p < 1:
        raise ValueError(f"The OT loss is only valid for p>=1, {p} was given")
    if target_constant:
        u_weights = u_weights.detach()
    alpha, beta, gaug = clipped_cdfs(grid, u_weights, v_weights, limit_quantile_range)

    if p == 1.0:
        dg = gaug[1:] - gaug[:-1]
        return torch.sum(torch.abs(alpha[:, :-1] - beta[:, :-1]) * dg[None, :], dim=-1)
    if p == 2.0 and target_constant:
        return _W2MergeRef.apply(alpha, beta, gaug)
    raise NotImplementedError(
        f"wasserstein_same_grid(p={p}, target_constant={target_constant}) needs the "
        "banded-plane kernels (sot_tpu/ops/pallas/sot.py _fwd_kernel and _bwd_kernel, "
        "TPU kernels 6-7), which are not ported yet (ROADMAP queue B)")


def quantile_function(qs: torch.Tensor, cws: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """xs at the step-function inverse CDF: xs[searchsorted_left(cws, qs)],
    the index clamped to the grid."""
    n = xs.shape[-1]
    idx = torch.searchsorted(cws.contiguous(), qs.contiguous(), right=False)
    return torch.gather(xs, -1, torch.clamp(idx, 0, n - 1))


def wasserstein_1d(u_values: torch.Tensor, v_values: torch.Tensor,
                   u_weights: Optional[torch.Tensor] = None,
                   v_weights: Optional[torch.Tensor] = None, p: float = 1,
                   require_sort: bool = True, return_quantiles: bool = False,
                   limit_quantile_range: bool = False):
    """Batched closed-form 1D W_p^p (not its p-th root) between [rows, n] and
    [rows, m] distributions; uniform weights by default."""
    if p < 1:
        raise ValueError(f"The OT loss is only valid for p>=1, {p} was given")
    u_values = u_values.to(torch.float32)
    v_values = v_values.to(torch.float32)
    n, m = u_values.shape[-1], v_values.shape[-1]
    if u_weights is None:
        u_weights = torch.full_like(u_values, 1.0 / n)
    if v_weights is None:
        v_weights = torch.full_like(v_values, 1.0 / m)
    u_weights = u_weights.to(torch.float32)
    v_weights = v_weights.to(torch.float32)

    if require_sort:
        # one stable key-value sort per distribution (values carry weights)
        u_values, order = torch.sort(u_values, dim=-1, stable=True)
        u_weights = torch.gather(u_weights, -1, order)
        v_values, order = torch.sort(v_values, dim=-1, stable=True)
        v_weights = torch.gather(v_weights, -1, order)

    u_cw = prefix_sum(u_weights, axis=-1)
    v_cw = prefix_sum(v_weights, axis=-1)
    qs, _ = torch.sort(torch.cat([u_cw, v_cw], dim=-1), dim=-1)
    u_q = quantile_function(qs, u_cw, u_values)
    v_q = quantile_function(qs, v_cw, v_values)
    if return_quantiles:
        return u_q, v_q, qs, u_cw, v_cw

    qs_padded = F.pad(qs, (1, 0))
    delta = qs_padded[..., 1:] - qs_padded[..., :-1]
    if limit_quantile_range:
        delta = torch.where(qs > 1.0, torch.zeros_like(delta), delta)
    diff = torch.abs(u_q - v_q)
    if p == 1:
        return torch.sum(delta * diff, dim=-1)
    if p == 2:
        return torch.sum(delta * diff * diff, dim=-1)
    return torch.sum(delta * diff ** p, dim=-1)


def wasserstein_1d_same_grid(grid: torch.Tensor, u_weights: torch.Tensor,
                             v_weights: torch.Tensor, p: float = 1,
                             limit_quantile_range: bool = False,
                             target_constant: bool = False) -> torch.Tensor:
    """``wasserstein_1d(grid, grid, u, v)`` for one shared sorted grid."""
    if grid.ndim != 1:
        grid = grid[0]
    return wasserstein_same_grid(grid, u_weights, v_weights, p=p,
                                 limit_quantile_range=limit_quantile_range,
                                 target_constant=target_constant)
