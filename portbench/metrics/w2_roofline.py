"""The SOT W2 kernels' share of their roofline in a training cell: the
least time of one step's W2 value and gradient at the configuration's
shape, over the device time of whichever of kernels 4-8 run
(``ops/kernels/{plane,merge,refgrad}.py``), per step.

Rows are batch x transform frames, columns the rfft bins plus the tail
lane. The value reads the two clipped CDFs and the grid and writes one
number a row; the gradient reads them and the row weights and writes the
value side's cotangent (the target's CDF is data). Bytes bound both:
8.4 MB and 12.6 MB at 1024 x 1026, 0.0025 + 0.0038 ms at 3.35 TB/s.
Moves train_frames_per_s."""

from portbench import counts

KERNELS = ("plane_fwd_kernel", "plane_bwd_kernel", "coupling_fwd_kernel",
           "coupling_grad_kernel", "refgrad_kernel")


def w2_bytes(cfg: dict) -> tuple:
    """(value bytes, gradient bytes) of one step."""
    t, hop, n_fft = cfg["n_samples"], cfg["transform_hop"], cfg["transform_n_fft"]
    rows = cfg["batch_size"] * (-(-t // hop))
    n = n_fft // 2 + 1 + 1
    value = counts.F32 * (2 * rows * n + n + rows)
    grad = counts.F32 * (3 * rows * n + n + rows)
    return value, grad


def read(trace):
    cfg = trace.config
    if trace.kind != "train" or trace.units == 0 or not any(
            lc["kind"] == "wasserstein" for lc in cfg["losses"]):
        return None
    us = trace.kernel_us(lambda name: any(k in name for k in KERNELS))
    if us == 0:
        return None
    least = sum(b / counts.PEAK_BYTES for b in w2_bytes(cfg)) * trace.units
    return 100.0 * least / (us / 1e6)
