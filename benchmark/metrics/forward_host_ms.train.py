"""Host milliseconds a training step spent in the program's ``train.forward``
span (the ELBO's forward, ``loss_fn``), over the traced segment's steps."""

from benchmark import program_spans


def read(trace):
    return program_spans.host_ms(trace, "steps", "train.forward")
