"""The encoder convolutions' share of their roofline in a training cell
(``models/encoder.py``, on whatever implements them: cuDNN's f32
convolutions under ``auto``, kernels 10-11 under the ``conv`` gate): the
least time of every convolution's forward, weight gradient and input
gradient (the first one's input gradient is not needed) at
[batch x frames, channels, bins], each pass the larger of its operations at
the TF32 peak and its bytes at HBM speed, over the device time of the
kernels whose names ``is_conv`` accepts, per step. Moves
train_frames_per_s."""

import re

from portbench import counts

# cuDNN's convolution kernels (forward, data and weight gradients) and the
# port's kernels 10-11
_CONV = re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm|implicit_convolve|cudnn",
                   re.IGNORECASE)


def is_conv(name: str) -> bool:
    return bool(_CONV.search(name))


def least_step_seconds(cfg: dict) -> float:
    rows = cfg["batch_size"] * counts.of(cfg).frames_per_clip(cfg)
    length = counts.of(cfg).n_bins(cfg)
    total = 0.0
    for i, (_, ci, co, k) in enumerate(counts.of(cfg).convs(cfg)):
        flops = counts.conv_flops(ci, co, k, length, rows)
        for pass_ in ("fwd", "dw") + (("dx",) if i else ()):
            total += counts.least_seconds(flops, counts.conv_bytes(ci, co, k, length, rows, pass_))
    return total


def read(trace):
    if trace.kind != "train" or trace.units == 0:
        return None
    us = trace.kernel_us(is_conv)
    if us == 0:
        return None
    return 100.0 * least_step_seconds(trace.config) * trace.units / (us / 1e6)
