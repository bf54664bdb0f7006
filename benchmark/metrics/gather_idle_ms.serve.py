"""Device idle milliseconds a batch charged to the program's ``data.gather``
span: the instants of the traced segment's idle gaps that the span holds
innermost (``benchmark/program_spans.py``)."""

from benchmark import program_spans


def read(trace):
    return program_spans.idle_ms(trace, "batches", "data.gather")
