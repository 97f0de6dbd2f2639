"""dl_image_segmentation_tpu_torch -- the PyTorch + CUDA port of
dl_image_segmentation_tpu, for one NVIDIA H100.

Ported so far: chip creation (tile planning, scenes from a LocalCatalog
root -- windowed COG reads, five resamplers, cross-zone warps -- or the
synthetic catalog, scene compositing -- cloud-masked temporal median,
nearest-to-date mosaic --, vector label burning and GeoTIFF chip
pairs), the ``dlseg-torch`` command line (``python -m
dl_image_segmentation_tpu_torch.cli``), U-Net training (chips to TFRecord
shards, the training feed, optax-equal AdamW steps, scanned training
from a device pool, evaluation and checkpoints) and U-Net serving (the
model with its flax weight converter, predict, sliding-window
inference, the micro-batching HTTP server and stitch). The three Pallas kernels of
chip creation are hand-written CUDA kernels for Hopper (csrc/), built
with nvcc into the checkout's ``build/`` at first use; the U-Net's
convs, GroupNorm and transposed convs are cuDNN/cuBLAS calls through
torch. Entry points run on the CUDA card unless called with
``device="cpu"``.

The names of the reference's facade that the port has are exported
here, lazily, so ``import dl_image_segmentation_tpu_torch`` stays light.
"""

__version__ = "0.1.0"

_LAZY = {
    name: "dl_image_segmentation_tpu_torch.pipeline.chips"
    for name in ("DLTileJobConfig", "OGRLabelDataDesc",
                 "DLSampleCreationConfig", "create_chips_for_tile",
                 "create_label_array_for_tile", "create_img_array_for_tile",
                 "create_cloudmasked_s2_array", "stack_products_for_tile")
}
_LAZY["create_chips_for_tiles_batched"] = \
    "dl_image_segmentation_tpu_torch.pipeline.batch"
_LAZY["run_export"] = "dl_image_segmentation_tpu_torch.pipeline.export"
_LAZY["Trainer"] = _LAZY["TrainConfig"] = \
    "dl_image_segmentation_tpu_torch.train.trainer"
_LAZY["UNet"] = "dl_image_segmentation_tpu_torch.models.unet"
_LAZY["PredictServer"] = "dl_image_segmentation_tpu_torch.serve"
_LAZY["DeviceDataPool"] = "dl_image_segmentation_tpu_torch.train.pool"
_LAZY["TFRecordFeed"] = _LAZY["DevicePrefetcher"] = \
    "dl_image_segmentation_tpu_torch.pipeline.input"
_LAZY["process_dataset_mp"] = "dl_image_segmentation_tpu_torch.records.writers"

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(list(globals().keys()) + list(_LAZY.keys()))
