"""Host milliseconds a training step spent in ``next()`` on the prefetching
loader (the harness's ``loader`` span), averaged over the window's steps."""


def read(trace):
    n = trace.spans.count("loader")
    return trace.spans.total("loader") * 1e3 / n if n else None
