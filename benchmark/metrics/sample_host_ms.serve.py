"""Host milliseconds a batch spent in the program's ``serve.sample`` span
(``ProbabilisticUNet.sample``: the U-Net, the prior and the ensemble's
decode), over the traced segment's batches."""

from benchmark import program_spans


def read(trace):
    return program_spans.host_ms(trace, "batches", "serve.sample")
