"""Host milliseconds a batch spent gathering its days on the host and
copying them to the card (the harness's ``gather`` span), averaged over the
window's batches."""


def read(trace):
    n = trace.spans.count("gather")
    return trace.spans.total("gather") * 1e3 / n if n else None
