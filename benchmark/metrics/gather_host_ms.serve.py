"""Host milliseconds a batch spent in the program's ``data.gather`` span
(``ClimexDataset.get_hr_batch``: the numpy part of the harness's ``gather``,
without the pageable copy to the card), over the traced segment's batches."""

from benchmark import program_spans


def read(trace):
    return program_spans.host_ms(trace, "batches", "data.gather")
