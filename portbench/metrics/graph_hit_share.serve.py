"""Percent of the traced requests (the program's ``sot.predict`` spans)
served from the graph cache: those that hold no ``sot.predict.capture``
span. The cache's useful outcomes over its attempts; a capture on every
request reads 0. Moves serve_clips_per_s."""

from portbench import spans


def read(trace):
    calls = spans.named(trace, "sot.predict")
    if trace.kind != "serve" or not calls:
        return None
    captures = spans.inside(calls, spans.named(trace, "sot.predict.capture"))
    return 100.0 * sum(not c for c in captures) / len(calls)
