"""Prefix sums (``sot_tpu/ops/scan.py``).

The JAX package replaced ``jnp.cumsum`` with a blocked tri-matmul because
XLA lowers cumsum to a slow reduce-window on the TPU. The port uses
``torch.cumsum`` with a float64 accumulator and rounds each prefix once to
the input's dtype. On the CPU that is exactly what PyTorch's float32 cumsum
already does; on the GPU a float32 cumsum along a non-innermost dimension
accumulates sequentially in float32, which drifts by ~1e-2 rad over the
synth's 4096-sample phase (~1e4 rad). So the plain version is the same
function on both devices, and the synth kernel's phase matches it (see
``csrc/synth.cu``). Against the reference's blocked float32 order this is
the ulp-class difference the synth tolerances allow.
"""

from __future__ import annotations

import torch


def prefix_sum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inclusive prefix sum along ``axis``, accumulated in float64 and
    returned in the input's dtype."""
    if not x.is_floating_point():
        return torch.cumsum(x, dim=axis)
    return torch.cumsum(x, dim=axis, dtype=torch.float64).to(x.dtype)
