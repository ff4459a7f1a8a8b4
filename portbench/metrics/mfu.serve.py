"""The whole served forward's share of the card's TF32 peak: the CQT over
each bin's support and the encoder's convolutions and heads
(``counts.forward_flops``) per request, times the requests, over the traced
window's seconds. Moves serve_clips_per_s."""

from portbench import counts


def read(trace):
    if trace.kind != "serve" or trace.units == 0:
        return None
    flops = counts.of(trace.config).forward_flops(trace.config, trace.clips_per_unit) * trace.units
    return 100.0 * flops / trace.window_s / counts.PEAK_FLOPS
