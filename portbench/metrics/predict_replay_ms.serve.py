"""Median host length of the program's ``sot.predict.replay`` span
(``trainer.PredictGraph``): the graph's launch and the launch counting.
Moves serve_p95_ms."""

from portbench import spans


def read(trace):
    return spans.median_ms(trace, "sot.predict.replay")
