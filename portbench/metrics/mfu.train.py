"""The whole train step's share of the card's TF32 peak: the operations of
the step's forward and backward counted from the shapes
(``counts.train_step_flops``: the CQT over each bin's support, the
encoder's convolutions and heads, forward, weight and input gradients),
times the steps, over the traced window's seconds. Moves
train_frames_per_s."""

from portbench import counts


def read(trace):
    if trace.kind != "train" or trace.units == 0:
        return None
    flops = counts.of(trace.config).train_step_flops(trace.config, trace.clips_per_unit) * trace.units
    return 100.0 * flops / trace.window_s / counts.PEAK_FLOPS
