"""Device idle milliseconds a training step charged to the program's
``train.optimizer`` span: the instants of the traced segment's idle gaps that
the span holds innermost (``benchmark/program_spans.py``)."""

from benchmark import program_spans


def read(trace):
    return program_spans.idle_ms(trace, "steps", "train.optimizer")
