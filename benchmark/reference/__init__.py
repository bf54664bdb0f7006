"""The plain float32 reference that decides a run's ``correct``.

It imports torch and numpy only: nothing of the measured program, of its
JAX original or of the harness's program-facing code. Everything the
program derives from the shared inputs (the physical transform, the
statistics, the standardization, the dropout masks) is worked out here
again from the raw fields, the seed words and the seeded weights.
"""
