"""Device ops: compositing and label burning (chip creation), and batch
augmentation."""

from .augment import (augment_pairs, normalize, random_invert_pairs,
                      random_rotate_pairs, rotate_pairs)
from .compositing import (masked_median, masked_median_composite,
                          masked_median_kernel, nearest_valid_mosaic,
                          pad_stack)
from .rasterize import burn_binned, burn_dense, pack_features, rasterize

__all__ = [
    "augment_pairs", "burn_binned", "burn_dense", "masked_median",
    "masked_median_composite", "masked_median_kernel",
    "nearest_valid_mosaic", "normalize", "pack_features", "pad_stack",
    "random_invert_pairs", "random_rotate_pairs", "rasterize",
    "rotate_pairs",
]
