"""Protobuf wire format of tf.train.Example, encoded and decoded by hand.

A copy of the JAX package's ``records/proto.py``: the schema is small
and fixed, so the Example message is written directly, with map entries
sorted by key (protobuf's deterministic mode), byte for byte what
tf.train.Example.SerializeToString(deterministic=True) gives.

    message Example  { Features features = 1; }
    message Features { map<string, Feature> feature = 1; }
    message Feature  { oneof kind { BytesList bytes_list = 1;
                                    FloatList float_list = 2;
                                    Int64List int64_list = 3; } }
    message BytesList { repeated bytes value = 1; }
    message FloatList { repeated float value = 1 [packed]; }
    message Int64List { repeated int64 value = 1 [packed]; }
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np

__all__ = ["FeatureValue", "decode_example", "decode_varint",
           "encode_bytes_list_feature", "encode_example",
           "encode_float_list_feature", "encode_int64_list_feature",
           "encode_varint"]

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def encode_varint(value: int) -> bytes:
    """Unsigned LEB128; a negative int64 encodes as its 10-byte two's
    complement (protobuf's int64 rule)."""
    if value < 0:
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")
    return result, pos


def _decode_signed_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v, pos = decode_varint(buf, pos)
    if v >= 1 << 63:
        v -= 1 << 64
    return v, pos


def _tag(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + encode_varint(len(payload)) + payload


def encode_bytes_list_feature(values: Sequence[bytes]) -> bytes:
    """Feature{ bytes_list: BytesList{ value: values } }"""
    inner = b"".join(_len_delimited(1, v) for v in values)
    return _len_delimited(1, inner)


def encode_float_list_feature(values) -> bytes:
    """Feature{ float_list: FloatList{ value: packed f32 } }; float64
    values are rounded to float32 as the protobuf runtime does."""
    payload = np.ascontiguousarray(values, dtype="<f4").tobytes()
    if not payload:
        # TF omits the packed field of an empty list
        return _len_delimited(2, b"")
    inner = _tag(1, _WIRE_LEN) + encode_varint(len(payload)) + payload
    return _len_delimited(2, inner)


def encode_int64_list_feature(values: Sequence[int]) -> bytes:
    """Feature{ int64_list: Int64List{ value: packed varints } }"""
    payload = b"".join(encode_varint(int(v)) for v in values)
    if not payload:
        return _len_delimited(3, b"")
    inner = _tag(1, _WIRE_LEN) + encode_varint(len(payload)) + payload
    return _len_delimited(3, inner)


def encode_example(features: Dict[str, bytes]) -> bytes:
    """The Example of already-encoded Feature payloads, map entries
    sorted by key."""
    body = bytearray()
    for key in sorted(features):
        entry = (_len_delimited(1, key.encode("utf-8"))
                 + _len_delimited(2, features[key]))
        body += _len_delimited(1, entry)
    return _len_delimited(1, bytes(body))


class FeatureValue:
    """A decoded Feature: one of bytes_list / float_list (a float32 view
    of the record buffer where it can be) / int64_list."""

    __slots__ = ("kind", "bytes_list", "float_list", "int64_list")

    def __init__(self, kind, bytes_list=None, float_list=None,
                 int64_list=None):
        self.kind = kind
        self.bytes_list = bytes_list
        self.float_list = float_list
        self.int64_list = int64_list


def _iter_fields(buf, start: int, end: int
                 ) -> Iterator[Tuple[int, int, object]]:
    pos = start
    while pos < end:
        tag, pos = decode_varint(buf, pos)
        field = tag >> 3
        wire = tag & 7
        if wire == _WIRE_VARINT:
            val, pos = decode_varint(buf, pos)
            yield field, wire, val
        elif wire == _WIRE_LEN:
            ln, pos = decode_varint(buf, pos)
            yield field, wire, (pos, pos + ln)
            pos += ln
        elif wire == _WIRE_I64:
            yield field, wire, struct.unpack_from("<q", buf, pos)[0]
            pos += 8
        elif wire == _WIRE_I32:
            yield field, wire, struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_feature(buf, start: int, end: int) -> FeatureValue:
    for field, wire, val in _iter_fields(buf, start, end):
        if wire != _WIRE_LEN:
            continue
        s, e = val
        if field == 1:  # BytesList
            items: List[bytes] = [bytes(buf[v[0]:v[1]])
                                  for f2, w2, v in _iter_fields(buf, s, e)
                                  if f2 == 1 and w2 == _WIRE_LEN]
            return FeatureValue("bytes", bytes_list=items)
        if field == 2:  # FloatList
            # a packed field may arrive in several length-delimited
            # segments, which a parser must concatenate
            segs = []
            for f2, w2, v2 in _iter_fields(buf, s, e):
                if f2 == 1 and w2 == _WIRE_LEN:
                    segs.append(np.frombuffer(buf, dtype="<f4",
                                              count=(v2[1] - v2[0]) // 4,
                                              offset=v2[0]))
                elif f2 == 1 and w2 == _WIRE_I32:
                    segs.append(np.frombuffer(struct.pack("<i", v2),
                                              dtype="<f4"))
            if not segs:
                floats = np.empty(0, np.float32)
            elif len(segs) == 1:
                floats = segs[0]
            else:
                floats = np.concatenate(segs)
            return FeatureValue("float", float_list=floats)
        if field == 3:  # Int64List
            ints: List[int] = []
            for f2, w2, v2 in _iter_fields(buf, s, e):
                if f2 == 1 and w2 == _WIRE_LEN:
                    p = v2[0]
                    while p < v2[1]:
                        iv, p = _decode_signed_varint(buf, p)
                        ints.append(iv)
                elif f2 == 1 and w2 == _WIRE_VARINT:
                    ints.append(v2 if v2 < 1 << 63 else v2 - (1 << 64))
            return FeatureValue("int64", int64_list=ints)
    return FeatureValue("empty")


def decode_example(buf: Union[bytes, memoryview]
                   ) -> Dict[str, FeatureValue]:
    """A serialized tf.train.Example -> {name: FeatureValue}."""
    if isinstance(buf, memoryview):
        buf = bytes(buf)
    out: Dict[str, FeatureValue] = {}
    for field, wire, val in _iter_fields(buf, 0, len(buf)):
        if field != 1 or wire != _WIRE_LEN:
            continue
        for f2, w2, v2 in _iter_fields(buf, *val):
            if f2 != 1 or w2 != _WIRE_LEN:
                continue
            es, ee = v2  # one map entry
            key = feat = None
            for f3, w3, v3 in _iter_fields(buf, es, ee):
                if f3 == 1 and w3 == _WIRE_LEN:
                    key = bytes(buf[v3[0]:v3[1]]).decode("utf-8")
                elif f3 == 2 and w3 == _WIRE_LEN:
                    feat = v3
            if key is not None and feat is not None:
                out[key] = _decode_feature(buf, feat[0], feat[1])
    return out
