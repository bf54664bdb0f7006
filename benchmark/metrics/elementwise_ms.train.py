"""Device milliseconds a training step in kernels of no named family: not
cuDNN/cuBLAS, not the program's own kernels, not AdamW's multi-tensor
kernels (torch.profiler, by name)."""


def read(trace):
    steps = trace.units if "steps" in trace.work else 0
    if not steps or not trace.kernels:
        return None
    return trace.family_s(trace.counts.ELEMENTWISE) * 1e3 / steps
