"""TFRecord example parsers of the storage modes, with numpy outputs.

A copy of the JAX package's ``records/parsers.py``:

  'rgbraw'        encoded PNG/JPEG bytes   -> parse_encoded_rgb_img_proto
  'rgbarr'        uint8 array bytes        -> parse_8bit_array_proto
  'tifraw'        encoded GeoTIFF bytes    -> parse_encoded_gdal_proto_wrapped
                                              (float32 raw DNs)
  'tifraw_eager'  encoded GeoTIFF bytes    -> parse_encoded_gdal_proto_eager
                                              (the source dtype)
  'tifarr'        float32 FloatList arrays -> parse_higher_dtype_array_proto

GeoTIFF payloads decode through the port's own reader
(``raster/geotiff.py``), PNG and JPEG payloads through its own codecs
(``raster/png.py``, ``raster/jpeg.py``), where the JAX package uses PIL.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..raster.image import decode_image, decode_image_bytes
from . import proto

__all__ = ["parse_8bit_array_proto", "parse_encoded_gdal_proto_eager",
           "parse_encoded_gdal_proto_wrapped", "parse_encoded_rgb_img_proto",
           "parse_higher_dtype_array_proto"]

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


def parse_encoded_gdal_proto_wrapped(example_proto: bytes
                                     ) -> Tuple[np.ndarray, np.ndarray, bytes]:
    """Encoded GeoTIFF bytes -> float32 arrays (raw DNs)."""
    img_bytes, _, tgt_bytes, _, identifier = (
        _parse_byteslist_proto(example_proto))
    return (decode_image_bytes(img_bytes).array.astype(np.float32),
            decode_image_bytes(tgt_bytes).array.astype(np.float32),
            identifier)


def parse_encoded_gdal_proto_eager(example_proto: bytes
                                   ) -> Tuple[np.ndarray, np.ndarray, bytes]:
    """Encoded GeoTIFF bytes -> arrays in the source dtype."""
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
