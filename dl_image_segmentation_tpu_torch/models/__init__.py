"""Segmentation models: the U-Net (float and int8), DeepLab-lite and
SegFormer-lite, and their flax weight converter."""

from .convert import params_from_flax, quant_from_flax
from .deeplab import DeepLabLite
from .quant import Int8Conv
from .segformer import SegFormerLite
from .unet import ConvBlock, UNet, depth_to_space, space_to_depth

__all__ = ["ConvBlock", "DeepLabLite", "Int8Conv", "SegFormerLite", "UNet",
           "depth_to_space", "params_from_flax", "quant_from_flax",
           "space_to_depth"]
