"""The training step's FLOPs (counted over the plain reference on meta
tensors, ``benchmark/counts``) times the window's steps, over the window
and the card's bf16 dense peak, in percent."""


def read(trace):
    steps = trace.work.get("steps")
    if not steps:
        return None
    cell = trace.run.cell
    from benchmark import harness

    flops, _ = trace.counts.train_step(harness.sizes(cell), cell.params["members"])
    per_s = flops * cell.params["batch_size"] * steps / trace.window_s
    return 100.0 * per_s / trace.counts.PEAKS["flops_per_s"]["bfloat16"]
