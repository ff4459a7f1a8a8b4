"""Percent of the traced window's host-clock span (the harness's
``portbench.window`` span, not first to last kernel) in which no
operation ran on the device, in a training cell. Moves train_frames_per_s."""


def read(trace):
    if trace.kind != "train" or trace.busy_us == 0:
        return None
    return 100.0 * (1.0 - trace.busy_us / (trace.window_s * 1e6))
