"""Median over the traced requests of the request's host-clock span (the
harness's ``portbench.unit`` span around ``trainer.predict`` and the copy
of its outputs to the host) minus the device-busy time inside it: the
copy in, the launch, the clones and the copy out as the host waits for
them. Moves serve_p95_ms."""

import statistics


def read(trace):
    if trace.kind != "serve" or not trace.unit_spans or trace.busy_us == 0:
        return None
    return statistics.median((b - a - trace.busy_in(a, b)) / 1e3 for a, b in trace.unit_spans)
