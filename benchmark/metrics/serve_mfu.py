"""The prior ensemble's FLOPs a batch (counted over the plain reference on
meta tensors, ``benchmark/counts``) times the window's batches, over the
window and the card's bf16 dense peak, in percent."""


def read(trace):
    batches = trace.work.get("batches")
    if not batches:
        return None
    cell = trace.run.cell
    from benchmark import harness

    flops, _ = trace.counts.sample(harness.sizes(cell), cell.params["members"])
    per_s = flops * cell.params["batch_size"] * batches / trace.window_s
    return 100.0 * per_s / trace.counts.PEAKS["flops_per_s"]["bfloat16"]
