"""Median host length of the program's ``sot.predict.copy_in`` span
(``trainer.PredictGraph``): the request copied from pageable host memory
into the graph's input buffer. Moves serve_p95_ms."""

from portbench import spans


def read(trace):
    return spans.median_ms(trace, "sot.predict.copy_in")
