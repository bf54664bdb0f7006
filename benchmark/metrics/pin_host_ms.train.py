"""Host milliseconds a training step spent in the program's ``data.pin`` span
(the prefetcher's pinned slot: the wait on its last copy to the card, and
the host copy into it), over the traced segment's steps."""

from benchmark import program_spans


def read(trace):
    return program_spans.host_ms(trace, "steps", "data.pin")
