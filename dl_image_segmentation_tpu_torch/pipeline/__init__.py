"""Chip creation (tile planning, per-tile and batched chip jobs, the
resumable export loop) and the inference surfaces: sliding-window
prediction over one raster and stitching chips into a mosaic."""

from .batch import create_chips_for_tiles_batched
from .chips import (DLTileJobConfig, OGRLabelDataDesc,
                    DLSampleCreationConfig, create_chips_for_tile,
                    create_img_array_for_tile, create_cloudmasked_s2_array,
                    create_label_array_for_tile, stack_products_for_tile,
                    is_done)
from .export import run_export, ExportReport
from .stitch import stitch_folder, stitch_tiles
from .window import predict_windowed, window_origins

__all__ = [
    "DLTileJobConfig", "OGRLabelDataDesc", "DLSampleCreationConfig",
    "create_chips_for_tile", "create_chips_for_tiles_batched",
    "create_img_array_for_tile", "create_cloudmasked_s2_array",
    "create_label_array_for_tile", "stack_products_for_tile", "is_done",
    "run_export", "ExportReport", "predict_windowed", "stitch_folder",
    "stitch_tiles", "window_origins",
]
