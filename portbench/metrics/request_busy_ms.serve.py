"""Device-busy milliseconds per served request (``trainer.PredictGraph``'s
replay with its copies): the union of device intervals in the traced
window over the requests in it. Moves serve_clips_per_s."""


def read(trace):
    if trace.kind != "serve" or trace.units == 0 or trace.busy_us == 0:
        return None
    return trace.busy_us / 1e3 / trace.units
