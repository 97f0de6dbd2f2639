"""dl_image_segmentation_tpu_torch -- the PyTorch + CUDA port of
dl_image_segmentation_tpu, for one NVIDIA H100.

Ported: chip creation (tile planning, scenes from a LocalCatalog root --
windowed COG reads, five resamplers, cross-zone warps, per-band scene
files in any raster container the port decodes -- from HTTP and STAC
catalogs or the synthetic catalog, scene compositing -- cloud-masked
temporal median, nearest-to-date mosaic --, vector label burning and
GeoTIFF chip pairs), the ``dlseg-torch`` command line (``python -m
dl_image_segmentation_tpu_torch.cli``), training (chips to TFRecord
shards, the training feed, optax-equal AdamW steps, scanned training
from a device pool, evaluation and checkpoints, the JAX package's orbax
checkpoints read and written with the port's own zstd and OCDBT code)
and serving (the models with their flax weight converter, predict,
sliding-window inference, the micro-batching HTTP server and stitch) of
the U-Net, DeepLab-lite and SegFormer-lite, the U-Net's int8 inference,
storage on local disks, gs://, s3:// and http(s)://, and the port's own
raster codecs: GeoTIFF, PNG, JPEG, GIF, BMP and JPEG 2000 (Sentinel-2
``.SAFE`` ingestion), HDF5 / NetCDF-4 (its own reader, where the JAX
package uses h5py), and copies of the JAX package's decoders of NetCDF
classic, GRIB 1 and 2, VRT, ENVI, HDF4, NITF and GeoPackage rasters. The
three
Pallas kernels of chip creation are hand-written CUDA kernels for Hopper
(csrc/), built with nvcc into the checkout's ``build/`` at first use;
the models' convs, norms, matmuls and attention are cuDNN/cuBLAS calls
through torch, their int8 convs ``torch._int_mm``. Entry points run on
the CUDA card unless called with ``device="cpu"``.

The 22 names of the JAX package's facade (the reference's 18 and the
four graph-mode ``*_tf`` parsers) are exported here with the port's own
names, all lazily: ``import dl_image_segmentation_tpu_torch`` imports
neither TensorFlow nor matplotlib.
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
for _mod, _names in (
        ("records.writers", ("process_dataset_mp", "images_to_tfrecords_mp",
                             "images_to_tfrecords_mt")),
        ("records.example", ("convert_to_example",)),
        ("records.parsers", (
            "featuretemplate_bytestring_imagechip",
            "featuretemplate_ndarray_imagechip",
            "parse_encoded_rgb_img_proto", "parse_8bit_array_proto",
            "parse_encoded_gdal_proto_eager",
            "parse_encoded_gdal_proto_wrapped",
            "parse_higher_dtype_array_proto")),
        ("records.parsers_tf", (
            "parse_encoded_rgb_img_proto_tf", "parse_8bit_array_proto_tf",
            "parse_higher_dtype_array_proto_tf",
            "parse_encoded_gdal_proto_wrapped_tf"))):
    for _name in _names:
        _LAZY[_name] = "dl_image_segmentation_tpu_torch." + _mod
del _mod, _names, _name

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
