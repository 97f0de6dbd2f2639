"""dl_image_segmentation_tpu_torch -- the PyTorch + CUDA port of
dl_image_segmentation_tpu, for one NVIDIA H100.

This slice ports chip creation: tile planning, scene compositing
(cloud-masked temporal median, nearest-to-date mosaic), vector label
burning and GeoTIFF chip pairs. The three Pallas kernels of that path
are hand-written CUDA kernels for Hopper (csrc/), built with nvcc into
the checkout's ``build/`` at first use. Entry points run on the CUDA
card unless called with ``device="cpu"``.

The chip-creation names of the reference's facade are exported here,
lazily, so ``import dl_image_segmentation_tpu_torch`` stays light.
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
