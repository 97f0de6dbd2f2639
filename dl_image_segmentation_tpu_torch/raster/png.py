"""PNG decoder and encoder of the port (no PIL).

The JAX package decodes PNG through PIL (with a libdeflate fast path of
its own) and encodes through PIL; the GPU machine has neither, so the
port carries its own codec. Decode returns what the JAX package returns,
PIL's mode mapping included:

====================  =============================================
IHDR                  array (H, W, B)
====================  =============================================
grey 1-bit            bool, 1 band
grey 2 / 4-bit        uint8 scaled by 85 / 17, 1 band
grey 8 / 16-bit       uint8 / uint16, 1 band
RGB 8 / 16-bit        uint8, 3 bands (16-bit: the high byte)
palette, any depth    uint8 RGB, 3 bands (tRNS dropped; an index
                      past the palette's end is black)
grey+alpha 8-bit      uint8, 2 bands
grey+alpha 16-bit     uint8, 4 bands: grey, grey, grey, alpha (high
                      bytes)
RGBA 8 / 16-bit       uint8, 4 bands (16-bit: the high byte)
====================  =============================================

Chunks are parsed here as PIL reads them: the CRC of every chunk before
the first IDAT is checked, the IDAT chunks' are not (PIL's loader skips
them), and the image data ends at the first chunk after it of another
type. The IDAT chunks are joined and inflated with stdlib ``zlib``; the
scanlines are unfiltered and de-interlaced (Adam7) in C++
(``csrc/host/png.cc``, built with g++ into ``build/`` at first use and
called through ctypes). The pixel
count is capped from the header, before anything is allocated, at PIL's
decompression-bomb limit.

The encoder writes uint8 1-3 bands and uint16 1 band, choosing each
row's filter by the smallest sum of absolute filtered bytes and
deflating with ``zlib``. Its bytes need not equal PIL's (zlib versions
differ); its pixels do.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from .. import _build
from .codec_errors import TruncatedData, UnknownFilter

__all__ = ["MAX_PIXELS", "PNGError", "decode_png_array", "decoded_layout",
           "encode_png_array", "png_header"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "png.cc")
_CMD = ("g++", "-O3", "-shared", "-fPIC")
_SIGNATURES = {
    "fc_png_raw_size": (ctypes.c_uint64, [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]),
    "fc_png_unfilter": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PIL refuses images above twice Image.MAX_IMAGE_PIXELS
# (DecompressionBombError); so does the port
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


class PNGError(ValueError):
    """A PNG that does not parse or decode."""


class PNGTruncated(PNGError, TruncatedData):
    """PNG image data that ends before the image is whole."""


class PNGFilterError(PNGError, UnknownFilter):
    """A scanline of a filter type past 4."""


def _lib():
    return _build.load(_CMD, _SRC, _SIGNATURES)


def png_header(data: bytes):
    """(width, height, bit depth, colour type, interlace) from IHDR."""
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file")
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise PNGError("corrupt PNG header")
    w, h, depth, ct, comp, filt, il = struct.unpack(">IIBBBBB", data[16:29])
    if ct not in _DEPTHS or depth not in _DEPTHS[ct]:
        raise PNGError(f"bad PNG bit depth {depth} for colour type {ct}")
    if comp or filt or il not in (0, 1):
        raise PNGError(f"unknown PNG compression {comp}, filter {filt} "
                       f"or interlace {il}")
    if not w or not h or w >= 1 << 31 or h >= 1 << 31:
        raise PNGError(f"bad PNG size {w}x{h}")
    return w, h, depth, ct, il


def decoded_layout(depth: int, ct: int):
    """(bands, dtype name) of the decoded array."""
    if ct == 0:
        return 1, ("bool" if depth == 1 else
                   "uint16" if depth == 16 else "uint8")
    if ct == 4 and depth == 16:
        return 4, "uint8"
    return (3 if ct == 3 else _CHANNELS[ct]), "uint8"


_CID = frozenset(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 b"0123456789_")


def _chunks(data: bytes):
    """(type, body) of each chunk as PIL reads them, up to IEND or the
    last whole chunk of a truncated file (the decoder then finds its
    image data short). The CRCs of the chunks before the first IDAT are
    checked; the IDAT chunks' are not, a truncated IDAT gives what the
    file holds of it, and the image data ends at the first other chunk
    (an invalid chunk type there is PIL's SyntaxError)."""
    pos = 8
    n = len(data)
    seen_idat = False
    while pos + 8 <= n:
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if seen_idat:
            if not all(c in _CID for c in ctype):
                raise SyntaxError(f"broken PNG file (chunk {ctype!r})")
            if ctype != b"IDAT":
                return
        end = pos + 8 + length
        if length >= 1 << 31 or end + 4 > n:
            if ctype == b"IDAT":
                yield ctype, data[pos + 8:end]
            return
        body = data[pos + 8:end]
        if ctype == b"IDAT":
            seen_idat = True
        else:
            (crc,) = struct.unpack(">I", data[end:end + 4])
            if zlib.crc32(body, zlib.crc32(ctype)) != crc:
                raise PNGError(f"broken PNG file (bad checksum in {ctype!r})")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def _filter_error(raw: bytearray, stride: int, il: int):
    """PIL unfilters the rows as the data comes: a whole row read so far
    with a filter type past 4 fails before what comes after it."""
    whole = len(raw) // stride * stride
    if not il and whole and max(raw[:whole:stride]) > 4:
        return PNGFilterError("unknown PNG filter type")
    return None


def decode_png_array(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, B) array, as the JAX package decodes them."""
    w, h, depth, ct, il = png_header(data)
    if w * h > MAX_PIXELS:
        raise PNGError(f"image size ({w * h} pixels) exceeds the limit of "
                       f"{MAX_PIXELS} pixels (decompression bomb)")
    channels = _CHANNELS[ct]
    lib = _lib()
    need = lib.fc_png_raw_size(w, h, depth, channels, il)
    inflater = zlib.decompressobj()
    raw = bytearray()
    palette = None
    stride = 1 + (w * channels * depth + 7) // 8
    try:
        for ctype, body in _chunks(data):
            if ctype == b"PLTE":
                palette = body
            elif ctype == b"IDAT":
                try:
                    raw += inflater.decompress(body, need - len(raw))
                except zlib.error as e:
                    raise _filter_error(raw, stride, il) or PNGError(
                        f"corrupt PNG image data: {e}") from e
                if len(raw) >= need:
                    break
            elif ctype == b"IEND":
                break
    except SyntaxError as e:
        bad = _filter_error(raw, stride, il)
        if bad:
            raise bad from e
        raise
    if len(raw) < need:
        raise _filter_error(raw, stride, il) or PNGTruncated(
            f"image file is truncated ({len(raw)} of {need} bytes of image "
            "data)")
    if ct == 3 and (palette is None or not palette
                    or len(palette) % 3 or len(palette) > 768):
        raise PNGError("PNG palette missing or malformed")
    raw = bytes(raw)
    samples = np.empty((h, w, channels),
                       np.uint16 if depth == 16 else np.uint8)
    rc = lib.fc_png_unfilter(raw, len(raw), w, h, depth, channels, il,
                             samples.ctypes.data)
    if rc == -1:
        raise PNGFilterError("unknown PNG filter type")
    if rc:
        raise PNGError(f"PNG reconstruction failed ({rc})")
    if ct == 3:
        lut = np.zeros((256, 3), np.uint8)
        pal = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        lut[:len(pal)] = pal
        return lut[samples[:, :, 0]]
    if ct == 0:
        if depth == 1:
            return samples.astype(bool)
        if depth in (2, 4):
            return samples * np.uint8(255 // ((1 << depth) - 1))
        return samples
    if depth == 16:
        high = (samples >> 8).astype(np.uint8)
        if ct == 4:  # PIL's LA;16B -> RGBA
            return high[:, :, [0, 0, 0, 1]]
        return high
    return samples


def _filtered_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Each row (uint8, (H, stride)) filtered with the type of the
    smallest sum of absolute values (signed bytes), prefixed by it."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])
    cands = (cands & 0xFF).astype(np.uint8)
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(axis=2)
    best = cost.argmin(axis=0)
    chosen = cands[best, np.arange(rows.shape[0])]
    return np.concatenate([best.astype(np.uint8)[:, None], chosen],
                          axis=1).tobytes()


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))


def encode_png_array(array) -> bytes:
    """(H, W[, B]) uint8 with 1-3 bands, or uint16 with 1 band -> PNG."""
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[0] < 1 or arr.shape[1] < 1:
        raise ValueError(f"cannot encode an array of shape {arr.shape} "
                         "as PNG")
    h, w, bands = arr.shape
    if arr.dtype == np.uint8 and bands in (1, 2, 3):
        depth, ct = 8, {1: 0, 2: 4, 3: 2}[bands]
        rows = np.ascontiguousarray(arr).reshape(h, w * bands)
    elif arr.dtype == np.uint16 and bands == 1:
        depth, ct = 16, 0
        rows = np.ascontiguousarray(arr.astype(">u2")).view(
            np.uint8).reshape(h, w * 2)
    else:
        raise ValueError(f"PNG encoding takes uint8 with 1-3 bands or uint16 "
                         f"with 1 band, not {arr.dtype.name} with {bands}")
    bpp = bands * depth // 8
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ct, 0, 0, 0)
    idat = zlib.compress(_filtered_rows(rows, bpp), 6)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))
