"""ClimEx data: synthetic fields, physical transforms, host ingest
(``ClimexDataset``, the packed artifact), device-side preprocessing, batch
iteration and the host-to-device prefetch."""

from probunet_tpu_torch.data.transforms import (
    softplus,
    softplus_inv,
    kgm2s_to_mmday,
    k_to_c,
    apply_physical_transform,
    invert_physical_transform,
)
from probunet_tpu_torch.data.synthetic import synthetic_climex_fields
from probunet_tpu_torch.data.climex import ClimexDataset, Standardization
from probunet_tpu_torch.data.loader import Batches, prefetch_to_device

__all__ = [
    "softplus",
    "softplus_inv",
    "kgm2s_to_mmday",
    "k_to_c",
    "apply_physical_transform",
    "invert_physical_transform",
    "synthetic_climex_fields",
    "ClimexDataset",
    "Standardization",
    "Batches",
    "prefetch_to_device",
]
