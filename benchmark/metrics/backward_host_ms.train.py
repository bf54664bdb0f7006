"""Host milliseconds a training step spent in the program's ``train.backward``
span (``torch.autograd.grad`` through the gradients' reduction: autograd's
device thread launches the backward while the step's thread waits in it),
over the traced segment's steps."""

from benchmark import program_spans


def read(trace):
    return program_spans.host_ms(trace, "steps", "train.backward")
