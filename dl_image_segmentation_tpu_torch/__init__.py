"""dl_image_segmentation_tpu_torch -- the PyTorch + CUDA port of
dl_image_segmentation_tpu, for one NVIDIA H100.

Ported so far: chip creation (tile planning, scenes from a LocalCatalog
root -- windowed COG reads, five resamplers, cross-zone warps -- or the
synthetic catalog, scene compositing -- cloud-masked temporal median,
nearest-to-date mosaic --, vector label burning and GeoTIFF chip
pairs), the ``dlseg-torch`` command line (``python -m
dl_image_segmentation_tpu_torch.cli``), training (chips to TFRecord
shards, the training feed, optax-equal AdamW steps, scanned training
from a device pool, evaluation and checkpoints) and serving (the models
with their flax weight converter, predict, sliding-window inference, the
micro-batching HTTP server and stitch) of the U-Net, DeepLab-lite and
SegFormer-lite, and the U-Net's int8 inference (dynamic and calibrated
static scales), with its own PNG, JPEG, GIF and BMP codecs for PNG/JPEG
chips (``convert``, the MT shard engine, rgbraw records, image request
bodies), its own JPEG 2000 codec for Sentinel-2 ``.SAFE`` ingestion and
JP2 chips, and the JAX package's orbax checkpoints, read and written
with its own zstd and OCDBT code (``train/orbax.py``), so that a model
trained on the TPU resumes, evaluates and serves here. The three Pallas
kernels of chip creation are
hand-written CUDA kernels for Hopper (csrc/), built with nvcc into the
checkout's ``build/`` at first use; the models' convs, norms, matmuls and
attention are cuDNN/cuBLAS calls through torch, their int8 convs
``torch._int_mm``. Entry points run on the CUDA card unless called with
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
_LAZY["DeepLabLite"] = "dl_image_segmentation_tpu_torch.models.deeplab"
_LAZY["SegFormerLite"] = "dl_image_segmentation_tpu_torch.models.segformer"
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
