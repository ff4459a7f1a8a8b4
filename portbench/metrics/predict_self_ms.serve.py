"""Median over the traced requests of the host time of the program's
``sot.predict`` span (``trainer.predict``) that none of its parts covers:
the span's length less the union of its ``sot.predict.*`` child spans
(capture, copy in, replay, clones). What is left is the graph cache's
lookup, the weights' address check, ``torch.as_tensor`` and the dict.
Moves serve_p95_ms."""

import statistics

from portbench import spans
from portbench.trace import union

PARTS = ("sot.predict.capture", "sot.predict.copy_in", "sot.predict.replay",
         "sot.predict.clone_out")


def read(trace):
    calls = spans.named(trace, "sot.predict")
    if trace.kind != "serve" or not calls:
        return None
    parts = sorted(s for name in PARTS for s in spans.named(trace, name))
    return statistics.median((b - a - sum(y - x for x, y in union(kids))) / 1e3
                             for (a, b), kids in zip(calls, spans.inside(calls, parts)))
