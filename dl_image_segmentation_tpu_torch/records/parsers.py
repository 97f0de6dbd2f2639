"""TFRecord example parsers of the storage modes, with numpy outputs.

A copy of the JAX package's ``records/parsers.py``:

  'rgbraw'        encoded PNG/JPEG bytes   -> parse_encoded_rgb_img_proto
  'rgbarr'        uint8 array bytes        -> parse_8bit_array_proto
  'tifraw'        encoded raster bytes     -> parse_encoded_gdal_proto_wrapped
                                              (float32 raw DNs)
  'tifraw_eager'  encoded raster bytes     -> parse_encoded_gdal_proto_eager
                                              (the source dtype)
  'tifarr'        float32 FloatList arrays -> parse_higher_dtype_array_proto

Raster payloads (GeoTIFF, JPEG 2000, NetCDF, GRIB, ...) decode through
the port's ``decode_image_bytes``, PNG and JPEG payloads through its own
codecs (``raster/png.py``, ``raster/jpeg.py``), where the JAX package
uses PIL. The reference's pre-rename names (``parse_gdal_example_py``,
...) are kept as aliases. The feature templates
(``featuretemplate_bytestring_imagechip``,
``featuretemplate_ndarray_imagechip``: ``tf.io`` templates when
TensorFlow imports, spec dicts otherwise) and the graph-mode ``*_tf``
parsers (``records/parsers_tf.py``) resolve lazily, so importing this
module does not import TensorFlow.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..raster.image import decode_image, decode_image_bytes
from . import proto

__all__ = ["parse_8bit_array_example", "parse_8bit_array_proto",
           "parse_encoded_gdal_proto_eager", "parse_encoded_gdal_proto_wrapped",
           "parse_encoded_rgb_img_example", "parse_encoded_rgb_img_proto",
           "parse_gdal_example_py", "parse_gdal_example_tf",
           "parse_higher_dtype_array_proto", "parse_higher_example"]


_BYTES_TEMPLATE_SPEC = {
    "image/image_data": ("fixed", "string"),
    "image/height": ("fixed", "int64"),
    "image/width": ("fixed", "int64"),
    "image/channels": ("fixed", "int64"),
    "target/target_data": ("fixed", "string"),
    "target/height": ("fixed", "int64"),
    "target/width": ("fixed", "int64"),
    "identifier": ("fixed", "string"),
}

_ARRAY_TEMPLATE_SPEC = dict(
    _BYTES_TEMPLATE_SPEC, **{"image/image_data": ("var", "float32"),
                             "target/target_data": ("var", "float32")})


def _build_templates():
    """tf.io templates when TensorFlow imports, spec dicts otherwise."""
    try:
        import tensorflow as tf
    except Exception:
        return dict(_BYTES_TEMPLATE_SPEC), dict(_ARRAY_TEMPLATE_SPEC)

    def conv(spec):
        out = {}
        for k, (kind, dt) in spec.items():
            if kind == "fixed":
                out[k] = tf.io.FixedLenFeature(
                    [], tf.string if dt == "string" else tf.int64)
            else:
                out[k] = tf.io.FixedLenSequenceFeature(
                    [], dtype=tf.float32, allow_missing=True)
        return out

    return conv(_BYTES_TEMPLATE_SPEC), conv(_ARRAY_TEMPLATE_SPEC)


_templates_cache = None


def _templates():
    global _templates_cache
    if _templates_cache is None:
        _templates_cache = _build_templates()
    return _templates_cache


def _parse_byteslist_proto(example_proto: bytes):
    """(image bytes, (h, w, c), target bytes, (h, w), identifier)."""
    d = proto.decode_example(example_proto)
    ih = int(d["image/height"].int64_list[0])
    iw = int(d["image/width"].int64_list[0])
    ic = int(d["image/channels"].int64_list[0])
    th = int(d["target/height"].int64_list[0])
    tw = int(d["target/width"].int64_list[0])
    return (d["image/image_data"].bytes_list[0], (ih, iw, ic),
            d["target/target_data"].bytes_list[0], (th, tw),
            d["identifier"].bytes_list[0])


def parse_encoded_rgb_img_proto(example_proto: bytes
                                ) -> Tuple[np.ndarray, np.ndarray, bytes]:
    """Encoded PNG/JPEG image and label bytes -> decoded arrays
    (image, target, identifier)."""
    img_bytes, _, tgt_bytes, _, identifier = (
        _parse_byteslist_proto(example_proto))
    return decode_image(img_bytes), decode_image(tgt_bytes), identifier


def parse_8bit_array_proto(example_proto: bytes
                           ) -> Tuple[np.ndarray, np.ndarray, bytes]:
    """Raw uint8 array bytes -> reshaped arrays."""
    img_bytes, im_shp, tgt_bytes, tgt_shp, identifier = (
        _parse_byteslist_proto(example_proto))
    img_1d = np.frombuffer(img_bytes, dtype=np.uint8)
    if img_1d.shape[0] != im_shp[0] * im_shp[1] * im_shp[2]:
        raise ValueError(f"Decoded shape is {img_1d.shape!r} - does not "
                         "match")
    tgt_1d = np.frombuffer(tgt_bytes, dtype=np.uint8)
    if tgt_1d.shape[0] != tgt_shp[0] * tgt_shp[1]:
        raise ValueError(f"target has {tgt_1d.shape[0]} bytes for shape "
                         f"{tgt_shp}")
    return img_1d.reshape(im_shp), tgt_1d.reshape(tgt_shp), identifier


def _decode_f32(data: bytes) -> np.ndarray:
    """Raster bytes -> float32 array (the tifraw decode, shared with the
    graph-mode parser)."""
    return decode_image_bytes(data).array.astype(np.float32)


def parse_encoded_gdal_proto_wrapped(example_proto: bytes
                                     ) -> Tuple[np.ndarray, np.ndarray, bytes]:
    """Encoded raster bytes -> float32 arrays (raw DNs)."""
    img_bytes, _, tgt_bytes, _, identifier = (
        _parse_byteslist_proto(example_proto))
    return _decode_f32(img_bytes), _decode_f32(tgt_bytes), identifier


def parse_encoded_gdal_proto_eager(example_proto: bytes
                                   ) -> Tuple[np.ndarray, np.ndarray, bytes]:
    """Encoded raster bytes -> arrays in the source dtype."""
    img_bytes, im_shp, tgt_bytes, tgt_shp, identifier = (
        _parse_byteslist_proto(example_proto))
    img_arr = decode_image_bytes(img_bytes).array
    target_arr = decode_image_bytes(tgt_bytes).array
    if img_arr.shape != im_shp or target_arr.shape[:2] != tgt_shp:
        raise ValueError(f"decoded shapes {img_arr.shape}, "
                         f"{target_arr.shape} do not match the record's "
                         f"{im_shp}, {tgt_shp}")
    return img_arr, target_arr, identifier


def parse_higher_dtype_array_proto(example_proto: bytes
                                   ) -> Tuple[np.ndarray, np.ndarray, bytes]:
    """FloatList arrays -> float32 image (h, w, c) and target (h, w)."""
    d = proto.decode_example(example_proto)
    ih = int(d["image/height"].int64_list[0])
    iw = int(d["image/width"].int64_list[0])
    ic = int(d["image/channels"].int64_list[0])
    th = int(d["target/height"].int64_list[0])
    tw = int(d["target/width"].int64_list[0])
    return (d["image/image_data"].float_list.reshape(ih, iw, ic),
            d["target/target_data"].float_list.reshape(th, tw),
            d["identifier"].bytes_list[0])


# the reference's pre-rename names
# (_tfrecord_image_translation.py:107,122,132; parse_tfrecords.ipynb)
parse_gdal_example_py = parse_encoded_gdal_proto_eager
parse_gdal_example_tf = parse_encoded_gdal_proto_wrapped
parse_8bit_array_example = parse_8bit_array_proto
parse_encoded_rgb_img_example = parse_encoded_rgb_img_proto
parse_higher_example = parse_higher_dtype_array_proto


def __getattr__(name):
    """The graph-mode ``*_tf`` parsers and the feature templates, which
    import TensorFlow, resolve on first use."""
    if name.startswith("parse_") and name.endswith("_tf"):
        from . import parsers_tf
        return getattr(parsers_tf, name)
    if name == "featuretemplate_bytestring_imagechip":
        return _templates()[0]
    if name == "featuretemplate_ndarray_imagechip":
        return _templates()[1]
    raise AttributeError(name)
