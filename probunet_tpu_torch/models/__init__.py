"""Models: EDM layers and noise embeddings, the U-Net and its asymmetric
variants, the conv-Gaussian prior/posterior, Fcomb, the Probabilistic
U-Net, the deterministic baselines and the EDM preconditioned
denoiser."""

from probunet_tpu_torch.models.layers import (
    EDMConv,
    EDMLinear,
    EDMGroupNorm,
    FourierEmbedding,
    PositionalEmbedding,
    UNetBlock,
)
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
from probunet_tpu_torch.models.edm import EDMPrecond

__all__ = [
    "EDMConv",
    "EDMLinear",
    "EDMGroupNorm",
    "PositionalEmbedding",
    "FourierEmbedding",
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
    "EDMPrecond",
]
