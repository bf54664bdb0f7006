"""Host milliseconds a training step spent in the program's ``data.gather``
span (``ClimexDataset.get_hr_batch``: the batch's days indexed out of the
host split), over the traced segment's steps."""

from benchmark import program_spans


def read(trace):
    return program_spans.host_ms(trace, "steps", "data.gather")
