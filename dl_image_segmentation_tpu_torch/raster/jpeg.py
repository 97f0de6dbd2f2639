"""JPEG decoder and baseline encoder of the port (no PIL).

The JAX package decodes and encodes JPEG through PIL, i.e. libjpeg-turbo
at its defaults. The port's codec is ``csrc/host/jpeg.cc`` (built with
g++ into ``build/`` at first use and called through ctypes), which
follows libjpeg-turbo's default paths step for step: its decode is bit
for bit PIL's (islow IDCT, fancy upsampling, integer YCbCr->RGB), its
encode byte for byte ``Image.save(format="JPEG", quality=q)`` (JFIF
1.01, 4:2:0 for RGB, standard Huffman tables, force_baseline).

The decoder takes the 8-bit frames PIL opens: sequential (SOF0/SOF1)
and progressive (SOF2) Huffman, sequential and progressive arithmetic
coding (SOF9/SOF10, with DAC conditioning), and lossless Huffman
(SOF3: predictors 1-7, point transform, restarts), of 1, 3 or 4
components, any sampling factors libjpeg-turbo accepts, restart
intervals and fill bytes. Four components decode to PIL's inverted CMYK
(``CMYK;I``): CMYK as it is, YCCK (Adobe transform 2) through
libjpeg-turbo's YCC->RGB. What PIL refuses the decoder refuses with a
:class:`JPEGError` (a corrupt container in the JAX package too): sample
precisions other than 8 bits, 2 or more than 4 components, hierarchical
frames, arithmetic-coded lossless frames, an empty frame (DNL), and an
arithmetic scan that runs past one of the 64 KiB blocks PIL feeds
libjpeg. A progressive file that libjpeg-turbo would decode with block
smoothing (its first coefficients not all refined to the last bit)
raises :class:`JPEGUnsupported`, which names ROADMAP queue 1 item 6;
truncated and corrupt files raise :class:`JPEGError`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build
from .codec_errors import TruncatedData
from .png import MAX_PIXELS

__all__ = ["JPEGError", "JPEGUnsupported", "decode_jpeg_array",
           "encode_jpeg_array", "jpeg_frame", "jpeg_header"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "jpeg.cc")
_CMD = ("g++", "-O3", "-shared", "-fPIC")
_SIGNATURES = {
    "fc_jpeg_header": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_int]),
    "fc_jpeg_decode": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_int]),
    "fc_jpeg_encode": (ctypes.c_int64, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64]),
}
_TRUNCATED, _UNSUPPORTED = -1, -3


class JPEGError(ValueError):
    """A JPEG that does not parse or decode (truncated or corrupt)."""


class JPEGTruncated(JPEGError, TruncatedData):
    """A JPEG whose markers or scan data end early."""


class JPEGUnsupported(JPEGError):
    """A JPEG variant the port does not decode."""


def _lib():
    return _build.load(_CMD, _SRC, _SIGNATURES)


def _raise(rc: int, err: bytes):
    msg = err.split(b"\0", 1)[0].decode("ascii", "replace")
    if rc == _UNSUPPORTED:
        raise JPEGUnsupported(
            f"unsupported JPEG variant: {msg}. Smoothing it as "
            "libjpeg-turbo does is ROADMAP queue 1 item 6")
    if rc == _TRUNCATED:
        raise JPEGTruncated(msg)
    raise JPEGError(msg or f"corrupt JPEG data ({rc})")


def jpeg_frame(data: bytes):
    """(height, width, [(h, v) sampling factors of each component]) of
    the frame, from the markers before the first scan."""
    dims = np.zeros(11, np.int32)
    err = ctypes.create_string_buffer(256)
    rc = _lib().fc_jpeg_header(data, len(data), dims.ctypes.data, err, 256)
    if rc:
        _raise(rc, err.raw)
    return int(dims[0]), int(dims[1]), [
        (int(dims[3 + 2 * c]), int(dims[4 + 2 * c])) for c in range(dims[2])]


def jpeg_header(data: bytes):
    """(height, width, components) from the markers before the first
    scan."""
    h, w, sampling = jpeg_frame(data)
    return h, w, len(sampling)


def decode_jpeg_array(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 1, 3 or 4) uint8, as PIL decodes them (four
    bands are PIL's inverted CMYK)."""
    h, w, c = jpeg_header(data)
    if h * w > MAX_PIXELS:
        raise JPEGError(f"image size ({h * w} pixels) exceeds the limit of "
                        f"{MAX_PIXELS} pixels (decompression bomb)")
    out = np.empty((h, w, c), np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = _lib().fc_jpeg_decode(data, len(data), out.ctypes.data, out.size,
                               err, 256)
    if rc:
        _raise(rc, err.raw)
    return out


def encode_jpeg_array(array, quality: int = 100) -> bytes:
    """(H, W[, 1 or 3]) uint8 -> JPEG bytes equal to PIL's
    ``Image.fromarray(a).save(f, format="JPEG", quality=quality)``."""
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (1, 3):
        raise ValueError(f"JPEG encoding takes uint8 with 1 or 3 bands, not "
                         f"{arr.dtype.name} of shape {arr.shape}")
    h, w, c = arr.shape
    if not (0 < h <= 65500 and 0 < w <= 65500):
        raise ValueError(f"JPEG dimensions {w}x{h} out of range")
    arr = np.ascontiguousarray(arr)
    blocks = ((h + 15) // 16) * ((w + 15) // 16) * 6
    cap = 4096 + blocks * 64 * 7  # each coefficient at most 26 bits, stuffed
    out = np.empty(cap, np.uint8)
    n = _lib().fc_jpeg_encode(arr.ctypes.data, h, w, c, int(quality),
                              out.ctypes.data, cap)
    if n < 0:
        raise ValueError(f"JPEG encoding failed ({n})")
    return out[:n].tobytes()
