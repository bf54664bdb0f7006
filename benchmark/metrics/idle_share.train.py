"""The share of the traced segment of a training run in which no operation ran
on the card (1 - the union of device activity / the segment), in percent."""


def read(trace):
    if "steps" not in trace.work or not trace.units or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.traced_s)
