"""Beta warm-up / annealing schedule (port of ``probunet_tpu/train/schedule.py``,
unchanged: plain Python).

Pure function of the epoch number, replacing the reference's in-loop mutation
of ``model.beta_1`` (reference src/main.py:141-155):

- epochs 1..warmup: (beta_0, beta_1) = (1, 0);
- afterwards beta_1 ramps linearly from 0 to max_beta_1 over the remaining
  epochs: progress = (epoch - warmup) / (num_epochs - warmup), clipped to 1.

Note the reference computes the NEXT epoch's beta after training epoch
``e`` — i.e. the beta used during epoch e is schedule(e) with the convention
below (schedule(1) = warmup values; the first annealed value applies at
epoch warmup + 2 because the update happens post-epoch). We reproduce that
off-by-one faithfully: beta used while training epoch e equals
``beta_schedule(e - 1, ...)`` of the mathematical ramp, which this function
implements directly — pass the current epoch and it returns the betas to
train that epoch with.
"""

from __future__ import annotations


def beta_schedule(
    epoch: int,
    num_epochs: int,
    warmup_epochs: int = 2,
    max_beta_1: float = 1.0,
) -> tuple[float, float]:
    """Betas in effect while training `epoch` (1-indexed).

    Matches the reference loop (src/main.py:120-155) where betas are updated
    AFTER each epoch: epoch e trains with the betas computed at the end of
    epoch e-1.
    """
    prev = epoch - 1
    if prev <= warmup_epochs:
        return 1.0, 0.0
    total_annealing = num_epochs - warmup_epochs
    progress = min((prev - warmup_epochs) / total_annealing, 1.0)
    return 1.0, progress * max_beta_1
