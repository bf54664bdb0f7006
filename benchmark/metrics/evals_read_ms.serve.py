"""Host milliseconds a batch was blocked in the program's ``evals.read`` span
(``EvalAccumulator.update``'s reads of its partials to the host, which wait
for the batch's work on the card), over the traced segment's batches."""

from benchmark import program_spans


def read(trace):
    return program_spans.host_ms(trace, "batches", "evals.read")
