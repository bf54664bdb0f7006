"""Kernel C in the prior ensemble: the least time its chains' shapes need
(``benchmark/counts.gn_bound_s``) over the time it took, in percent."""


def read(trace):
    batches = trace.units if "batches" in trace.work else 0
    took = trace.family_s("C fused_gn fwd")
    if not batches or took <= 0:
        return None
    cell, c = trace.run.cell, trace.counts
    from benchmark import harness

    _, chains = c.sample(harness.sizes(cell), cell.params["members"])
    dt, b = trace.facts["compute_dtype"], cell.params["batch_size"]
    least = sum(c.gn_bound_s((b,) + s[1:], drop, dt, False) for s, drop in chains)
    return 100.0 * least * batches / took
