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
  ``probunet_tpu/ops/pallas/dropout.py``;
- :mod:`.int8_conv` — the int8 serving path's convolution (kernel E),
  which no TPU kernel computes: the JAX package leaves it to XLA
  (``probunet_tpu/ops/quantize.py:int8_conv``);
- :mod:`.avg_pool` — the ingest's k x k window mean in XLA's order of
  additions (kernel G, ``csrc/resample.cu``, on a route its per-shape plan
  picks), which no TPU kernel computes either
  (``probunet_tpu/ops/resample.py:avg_pool``, a reshape-mean).

Kernels F and F′, the int8 saved convolution inputs' quantization and
dequantization (``csrc/act_compress.cu``, fused by XLA in the JAX
package), have their wrappers beside the autograd function that calls
them, in ``probunet_tpu_torch/ops/act_compress.py`` (the JAX module's
path).

A wrapper runs the plain version for a CPU tensor and launches its kernel
for a CUDA tensor, or raises: there is no fallback from the kernel. Each
wrapper counts its launches in a plain integer attribute, ``launches``.
"""
