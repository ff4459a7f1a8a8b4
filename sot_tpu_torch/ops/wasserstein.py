"""1D Wasserstein distance, spectral optimal transport (``sot_tpu/ops/
wasserstein.py`` and the same-grid entry of ``sot_tpu/ops/pallas/sot.py``).

  * ``wasserstein_1d`` — the general closed form by quantile matching
    (sort -> cumsum -> merged quantile grid -> searchsorted lookups), plain
    PyTorch; gradients flow through the sorted weights and the gathered
    values, as in the reference
  * ``wasserstein_same_grid`` — both spectra on one shared sorted grid (the
    training hot path): CDFs, the quantile cap, the augmented tail lane,
    then the p = 1 closed form, or one of four routes (``w2_route``), each
    an ``autograd.Function`` around hand-written kernels:

      ``ref``    merge-coupling value (kernel B4) + reference-convention
                 beta gradient (kernel B5); a constant target only
      ``hybrid`` merge-coupling value (B4) + banded-plane backward (B7)
      ``plane``  banded-plane value (B6) + banded-plane backward (B7)
      ``full``   merge-coupling value (B4) + its min-halving gradient (B8)

    The first three give the plane kernel's gradient convention; ``full``
    gives the min-halving one (``sot_tpu/ops/pallas/merge.py:_coupling``),
    which differs at the cap-tie kinks by design. p other than 1 and 2
    always takes ``plane``; ``ref`` with a target that needs a gradient
    becomes ``hybrid`` (``sot.py:676-724``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sot_tpu_torch.kernel_gates import Kernels, resolve_gates
from sot_tpu_torch.ops.kernels.merge import coupling, coupling_grads, sot_w2_merge
from sot_tpu_torch.ops.kernels.plane import sot_plane_backward, sot_plane_forward
from sot_tpu_torch.ops.kernels.refgrad import ref_grad_beta
from sot_tpu_torch.ops.scan import prefix_sum

# The largest bin count (before the tail lane) that ``w2_merge_small``
# overrides (``SOT_TPU_W2_SMALL_N``'s default).
SMALL_N = 512


def w2_route(n_bins: int, kernels: Kernels = "auto") -> str:
    """The same-grid W_2 route for rows of ``n_bins`` bins under the gates
    ``kernels`` (a ``KernelGates`` or a preset name), as the JAX package's
    ``sot.py:_merge_mode`` chooses it: ``w2_merge_small`` at or below
    ``SMALL_N`` bins when it is set, else ``w2_merge``; ``off`` is the
    banded plane (``plane``).

    ``auto`` gives the route that ``kernel_gates.auto_gates`` adopts from
    the committed H100 A/Bs (``sot_tpu_torch/adoption/``); ``default`` (no
    gate set) gives ``plane``."""
    gates = resolve_gates(kernels)
    mode = gates.w2_merge
    if n_bins <= SMALL_N and gates.w2_merge_small:
        mode = gates.w2_merge_small
    return "plane" if mode == "off" else mode


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


class _W2MergeHybrid(torch.autograd.Function):
    """W_2^2 rows: merge-coupling forward, banded-plane backward; alpha gets
    its cotangent unless the target is constant (``_w2_merge_hybrid``)."""

    @staticmethod
    def forward(ctx, alpha, beta, g, alpha_grads):
        ctx.save_for_backward(alpha, beta, g)
        ctx.alpha_grads = alpha_grads
        return sot_w2_merge(alpha, beta, g)

    @staticmethod
    def backward(ctx, wbar):
        alpha, beta, g = ctx.saved_tensors
        da, db = sot_plane_backward(alpha, beta, g, 2.0, wbar.contiguous(), ctx.alpha_grads)
        return da, db, None, None


class _SotPlane(torch.autograd.Function):
    """W_p^p rows: banded-plane forward and backward
    (``_sot_bilinear_pallas`` and, without ``alpha_grads``, its
    target-constant variant)."""

    @staticmethod
    def forward(ctx, alpha, beta, g, p, alpha_grads):
        ctx.save_for_backward(alpha, beta, g)
        ctx.p, ctx.alpha_grads = p, alpha_grads
        return sot_plane_forward(alpha, beta, g, p)

    @staticmethod
    def backward(ctx, wbar):
        alpha, beta, g = ctx.saved_tensors
        da, db = sot_plane_backward(alpha, beta, g, ctx.p, wbar.contiguous(), ctx.alpha_grads)
        return da, db, None, None, None


class _W2MergeFull(torch.autograd.Function):
    """S = sum_kl x_k x_l min(cap - alpha_body_k, cap - beta_body_l) per row
    (``sot_tpu/ops/pallas/merge.py:_coupling``): the value from kernel B4,
    the cotangents from kernel B8 in the min-halving convention.

    It takes the bodies and the cap apart, as JAX's ``_coupling`` does, so
    that the cap lane's cotangent is wbar (sum x)^2 whatever
    ``alpha_grads`` is: without alpha gradients, autograd of a = cap -
    alpha_body would give the cap only the b half. x is a grid quantity
    (no cotangent). JAX shaves the last column (x[-1] == 0, since the
    augmented grid repeats its last point) and adds O(n) boundary terms;
    this covers all columns, where that column's x = 0 adds nothing to any
    sum: the two agree."""

    @staticmethod
    def forward(ctx, alpha_body, beta_body, cap, x, alpha_grads):
        ctx.save_for_backward(alpha_body, beta_body, cap, x)
        ctx.alpha_grads = alpha_grads
        return coupling(cap[:, None] - alpha_body, cap[:, None] - beta_body, x)

    @staticmethod
    def backward(ctx, wbar):
        alpha_body, beta_body, cap, x = ctx.saved_tensors
        da, db = coupling_grads(cap[:, None] - alpha_body, cap[:, None] - beta_body, x,
                                ctx.alpha_grads)
        xsum = torch.sum(x)
        dcap = wbar * (xsum * xsum)
        w = wbar[:, None]
        return (None if da is None else -w * da), -w * db, dcap, None, None


def sot_w2_merge_full(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor,
                      target_constant: bool = False) -> torch.Tensor:
    """W_2^2 rows through the ``full`` route (``merge.py:sot_w2_merge``):
    the marginal and linear terms by autograd, the coupling by
    ``_W2MergeFull``; the alpha body gets no cotangent under
    ``target_constant`` (the cap lane keeps its own)."""
    alpha_grads = not target_constant
    return sot_w2_merge(alpha, beta, g, lambda al, be, cap, x: _W2MergeFull.apply(
        al, be, cap, x, alpha_grads))


def sot_bilinear(alpha: torch.Tensor, beta: torch.Tensor, g: torch.Tensor, p: float = 2.0,
                 target_constant: bool = False) -> torch.Tensor:
    """sum_ij relu(min(a_i, b_j) - max(a_{i-1}, b_{j-1})) |g_i - g_j|^p per
    row, for nondecreasing clipped CDFs alpha, beta [rows, n] on the sorted
    grid g [n]; alpha gets no cotangent under ``target_constant``."""
    if target_constant:
        alpha = alpha.detach()
    return _SotPlane.apply(alpha, beta, g, float(p), not target_constant)


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
                          target_constant: bool = False,
                          kernels: Kernels = "auto") -> torch.Tensor:
    """W_p^p between weight rows [rows, n] on one shared sorted grid [n] ->
    [rows]. ``limit_quantile_range`` integrates quantile levels up to the
    largest CDF value <= 1 (the paper's frequency cutoff); ``kernels`` (a
    ``KernelGates`` or a preset name) chooses the p = 2 route
    (``w2_route``)."""
    if p < 1:
        raise ValueError(f"The OT loss is only valid for p>=1, {p} was given")
    if target_constant:
        u_weights = u_weights.detach()
    route = w2_route(u_weights.shape[-1], kernels)
    alpha, beta, gaug = clipped_cdfs(grid, u_weights, v_weights, limit_quantile_range)

    if p == 1.0:
        dg = gaug[1:] - gaug[:-1]
        return torch.sum(torch.abs(alpha[:, :-1] - beta[:, :-1]) * dg[None, :], dim=-1)
    if p != 2.0:
        route = "plane"
    if route == "full":
        return sot_w2_merge_full(alpha, beta, gaug, target_constant)
    if route == "ref":
        if target_constant:
            return _W2MergeRef.apply(alpha, beta, gaug)
        route = "hybrid"  # the target's cotangent comes from the plane backward
    if route == "hybrid":
        return _W2MergeHybrid.apply(alpha, beta, gaug, not target_constant)
    return sot_bilinear(alpha, beta, gaug, p=p, target_constant=target_constant)


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
                             target_constant: bool = False,
                             kernels: Kernels = "auto") -> torch.Tensor:
    """``wasserstein_1d(grid, grid, u, v)`` for one shared sorted grid."""
    if grid.ndim != 1:
        grid = grid[0]
    return wasserstein_same_grid(grid, u_weights, v_weights, p=p,
                                 limit_quantile_range=limit_quantile_range,
                                 target_constant=target_constant, kernels=kernels)
