"""Segmentation models: the U-Net and its flax weight converter."""

from .convert import unet_params_from_flax
from .unet import ConvBlock, UNet, depth_to_space, space_to_depth

__all__ = ["ConvBlock", "UNet", "depth_to_space", "space_to_depth",
           "unet_params_from_flax"]
