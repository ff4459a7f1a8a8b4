"""Median host length of the program's ``sot.predict.clone_out`` span
(``trainer.PredictGraph``): every output cloned out of the graph's
buffers. Moves serve_p95_ms."""

from portbench import spans


def read(trace):
    return spans.median_ms(trace, "sot.predict.clone_out")
