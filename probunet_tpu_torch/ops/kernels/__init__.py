"""Hand-written CUDA kernels for Hopper (sources in ``probunet_tpu_torch/csrc``).

Each module holds one kernel's wrapper and its plain PyTorch version:

- :mod:`.afcrps` — ensemble CRPS terms (t1, t2), forward and backward,
  replacing ``probunet_tpu/ops/pallas/afcrps.py``;
- :mod:`.fcomb_crps` — Fcomb decode fused with the CRPS terms, forward
  and backward, replacing ``probunet_tpu/ops/pallas/fcomb_crps.py``;
- :mod:`.fused_gn` — the U-Net's GroupNorm -> FiLM -> SiLU -> dropout
  chain, forward and backward, replacing
  ``probunet_tpu/ops/pallas/fused_gn.py``;
- :mod:`.dropout` — zero-storage hash dropout, replacing
  ``probunet_tpu/ops/pallas/dropout.py``.

A wrapper runs the plain version for a CPU tensor and launches its kernel
for a CUDA tensor, or raises: there is no fallback from the kernel. Each
wrapper counts its launches in a plain integer attribute, ``launches``.
"""
