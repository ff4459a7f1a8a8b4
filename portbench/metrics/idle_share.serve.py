"""Percent of the traced window's host-clock span in which no operation ran
on the device, in a serving cell. Moves serve_clips_per_s."""


def read(trace):
    if trace.kind != "serve" or trace.busy_us == 0:
        return None
    return 100.0 * (1.0 - trace.busy_us / (trace.window_s * 1e6))
