"""Kernels a training step launched inside the program's ``train.optimizer``
span (``global_norm`` and AdamW's multi-tensor step), from the traced
segment's runtime events (``benchmark/program_spans.py``)."""

from benchmark import program_spans


def read(trace):
    return program_spans.launches(trace, "steps", "train.optimizer")
