"""Kernels A and A′ in the training step: the least time the fused
combination head and afCRPS need at the step's shapes
(``benchmark/counts.fcomb_crps_bound_s``, bytes or operations, whichever
is longer) over the time they took, in percent."""


def read(trace):
    steps = trace.units if "steps" in trace.work else 0
    took = trace.family_s("A fcomb_crps fwd", "A' fcomb_crps bwd")
    if not steps or took <= 0:
        return None
    cell, c = trace.run.cell, trace.counts
    from benchmark import harness

    s = harness.sizes(cell)
    b, m, dt = cell.params["batch_size"], cell.params["members"], trace.facts["compute_dtype"]
    p = s["resolution"][0] * s["resolution"][1]
    c0, k = s["num_filters"][0], s["num_classes"]
    least = (c.fcomb_crps_bound_s(b, p, m, c0, k, dt, False)
             + c.fcomb_crps_bound_s(b, p, m, c0, k, dt, True))
    return 100.0 * least * steps / took
