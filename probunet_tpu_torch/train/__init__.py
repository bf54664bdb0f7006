"""Evaluation steps (the training step is not ported yet)."""
