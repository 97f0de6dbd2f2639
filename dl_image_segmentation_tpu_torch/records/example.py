"""Example codec: an (image, label) pair -> serialized tf.train.Example.

A copy of the JAX package's ``records/example.py`` with the same bytes,
including its storage promotion rule:

* the image qualifies for bytes storage if it is raw ``bytes`` or a
  uint8 array;
* the target qualifies if it is raw ``bytes``, or a uint8 array and the
  image qualified;
* both are stored as BytesList only if both qualify, else both as
  float32 FloatList.

Schema: image/image_data, image/height, image/width, image/channels,
target/target_data, target/height, target/width, identifier.
"""

from __future__ import annotations

import struct

import numpy as np

from . import proto
from .crc32c import masked_crc32c_native
from .tfrecord import frame_header, writeall

__all__ = ["encode_example_features", "storage_payloads",
           "write_example_framed"]


def _is_uint8_array(x) -> bool:
    return isinstance(x, np.ndarray) and x.dtype == np.uint8


def _as_flat_float(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x).reshape(-1)
    return np.asarray([x], dtype=np.float32).reshape(-1)


def _as_bytes_payload(x) -> bytes:
    if isinstance(x, bytes):
        return x
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x).tobytes()
    raise TypeError(f"cannot store {type(x)!r} as bytes feature")


def _stored_as_bytes(img_data, target_data) -> bool:
    image_is_bytes = isinstance(img_data, bytes) or _is_uint8_array(img_data)
    return image_is_bytes and (isinstance(target_data, bytes)
                               or _is_uint8_array(target_data))


def encode_example_features(img_data, target_data, img_h, img_w, img_b,
                            target_h, target_w, identifier) -> bytes:
    """The serialized 8-feature Example."""
    if _stored_as_bytes(img_data, target_data):
        img_feat = proto.encode_bytes_list_feature(
            [_as_bytes_payload(img_data)])
        tgt_feat = proto.encode_bytes_list_feature(
            [_as_bytes_payload(target_data)])
    else:
        img_feat = proto.encode_float_list_feature(_as_flat_float(img_data))
        tgt_feat = proto.encode_float_list_feature(
            _as_flat_float(target_data))
    if isinstance(identifier, str):
        identifier = identifier.encode("utf-8")
    return proto.encode_example({
        "image/image_data": img_feat,
        "image/height": proto.encode_int64_list_feature([int(img_h)]),
        "image/width": proto.encode_int64_list_feature([int(img_w)]),
        "image/channels": proto.encode_int64_list_feature([int(img_b)]),
        "target/target_data": tgt_feat,
        "target/height": proto.encode_int64_list_feature([int(target_h)]),
        "target/width": proto.encode_int64_list_feature([int(target_w)]),
        "identifier": proto.encode_bytes_list_feature([identifier]),
    })


def storage_payloads(img_data, target_data):
    """(image payload, target payload, is_bytes) under the promotion
    rule: raw bytes for BytesList, little-endian float32 for FloatList."""
    if _stored_as_bytes(img_data, target_data):
        return (_as_bytes_payload(img_data),
                _as_bytes_payload(target_data), True)
    img = np.ascontiguousarray(_as_flat_float(img_data), dtype="<f4")
    tgt = np.ascontiguousarray(_as_flat_float(target_data), dtype="<f4")
    return img.tobytes(), tgt.tobytes(), False


def write_example_framed(fileobj, img_data, target_data, img_h, img_w,
                         img_b, target_h, target_w, identifier) -> int:
    """Serialize and frame one example into an open file; returns the
    bytes written."""
    rec = encode_example_features(img_data, target_data, img_h, img_w,
                                  img_b, target_h, target_w, identifier)
    writeall(fileobj, frame_header(len(rec)))
    writeall(fileobj, rec)
    writeall(fileobj, struct.pack("<I", masked_crc32c_native(rec)))
    return len(rec) + 16
