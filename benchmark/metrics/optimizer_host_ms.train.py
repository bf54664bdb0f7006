"""Host milliseconds a training step spent in the program's ``train.optimizer``
span (``global_norm`` and AdamW's step), over the traced segment's steps."""

from benchmark import program_spans


def read(trace):
    return program_spans.host_ms(trace, "steps", "train.optimizer")
