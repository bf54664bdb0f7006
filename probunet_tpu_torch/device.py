"""Where the port's entry points run.

The entry points (``ProbabilisticUNet.from_config``, ``create_train_state``,
``Trainer``) take ``device=`` and default to the CUDA device. Without one
they raise: a run never carries on on the CPU unless the caller asks for
it with ``device="cpu"`` (as the CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch device for ``device`` ("cuda" when None); raises for a
    CUDA device when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return dev
