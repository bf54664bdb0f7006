"""Models: EDM layers, the U-Net and its asymmetric variants, the
conv-Gaussian prior/posterior, Fcomb, the Probabilistic U-Net and the
deterministic baselines. The JAX package's EDM modules
(``PositionalEmbedding``, ``FourierEmbedding``, ``EDMPrecond``) are not
ported yet."""

from probunet_tpu_torch.models.layers import EDMConv, EDMLinear, EDMGroupNorm, UNetBlock
from probunet_tpu_torch.models.unet import (
    UNet,
    PostUNetWithSkips,
    PostUNetWithoutSkips,
    UNetAll,
)
from probunet_tpu_torch.models.gaussian import AxisAlignedConvGaussian
from probunet_tpu_torch.models.fcomb import Fcomb
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.models.baselines import LinearCNN, bcsd

__all__ = [
    "EDMConv",
    "EDMLinear",
    "EDMGroupNorm",
    "UNetBlock",
    "UNet",
    "PostUNetWithSkips",
    "PostUNetWithoutSkips",
    "UNetAll",
    "AxisAlignedConvGaussian",
    "Fcomb",
    "ProbabilisticUNet",
    "LinearCNN",
    "bcsd",
]
