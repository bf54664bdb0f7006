"""Kernels C and C′ in the training step: the least time their chains'
shapes need (``benchmark/counts.gn_bound_s``, each chain forward and
backward) over the time they took, in percent."""


def read(trace):
    steps = trace.units if "steps" in trace.work else 0
    took = trace.family_s("C fused_gn fwd", "C' fused_gn bwd")
    if not steps or took <= 0:
        return None
    cell, c = trace.run.cell, trace.counts
    from benchmark import harness

    _, chains = c.train_step(harness.sizes(cell), cell.params["members"])
    dt, b = trace.facts["compute_dtype"], cell.params["batch_size"]
    least = sum(c.gn_bound_s((b,) + s[1:], drop, dt, False)
                + c.gn_bound_s((b,) + s[1:], drop, dt, True) for s, drop in chains)
    return 100.0 * least * steps / took
