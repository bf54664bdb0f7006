"""Device milliseconds a batch of the kernels launched inside the
harness's ``evals`` span (``EvalAccumulator.update``)."""


def read(trace):
    batches = trace.units if "batches" in trace.work else 0
    s = trace.span_device_s("evals") if batches else None
    return None if s is None else s * 1e3 / batches
