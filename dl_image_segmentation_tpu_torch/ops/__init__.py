"""Device ops of chip creation: compositing and label burning."""

from .compositing import (masked_median, masked_median_composite,
                          masked_median_kernel, nearest_valid_mosaic,
                          pad_stack)
from .rasterize import burn_binned, burn_dense, pack_features, rasterize

__all__ = [
    "burn_binned", "burn_dense", "masked_median",
    "masked_median_composite", "masked_median_kernel",
    "nearest_valid_mosaic", "pack_features", "pad_stack", "rasterize",
]
