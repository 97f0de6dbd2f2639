"""The uncompressed and run-length image formats PIL opens, decoded as
PIL 12.1 decodes them (no PIL).

PPM/PGM/PBM/PFM (binary and plain, PIL's maxval scaling), TGA (raw and
RLE, colour maps, origin), SGI (raw, RLE, 16 bits a sample), PCX, QOI,
IM, XBM, GBR and DDS (uncompressed, and the block formats
DXT1/DXT3/DXT5, BC2-BC5 as PIL's ``bcn`` decoder gives them).

Each ``open_*`` function is a transcription of the plugin's ``_open``:
it reads the header from a :class:`Reader` and raises what the plugin
raises there (PIL's opener walk moves on after a ``SyntaxError``, an
``IndexError``, a ``TypeError`` or a ``struct.error``, and lets anything
else out). It returns an :class:`Opened` whose ``load`` decodes the
pixels the way ``np.asarray`` of the PIL image would have them: one
2-D array per mode ("1" as bool, "I" int32, "F" float32, "I;16" little-
and "I;16B" big-endian uint16) or an (H, W, B) array, and failures of
PIL's loading stage (``ImageFile.load``): ``OSError`` "image file is
truncated (n bytes not processed)" when the data ends early, and the
decoders' own errors.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .. import _build

__all__ = ["DecompressionBombError", "MAX_IMAGE_PIXELS", "Opened", "Reader",
           "UnsupportedFormat", "apply_palette", "check_bomb", "item16",
           "read_rows", "truncated", "unpack", "unpremultiply"]

MAX_IMAGE_PIXELS = int(1024 * 1024 * 1024 // 4 // 3)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "pil_rle.cc")
_CMD = ("g++", "-O2", "-shared", "-fPIC", "-std=c++17")
_SIGNATURES = {
    "fc_qoi_decode": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "fc_sgi_rle_decode": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "fc_pcx_decode": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]),
}


def _lib():
    return _build.load(_CMD, _SRC, _SIGNATURES)


class Reader:
    """The parts of ``io.BytesIO`` the plugins' header parsers use."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int = -1) -> bytes:
        if self.pos >= len(self.data):
            return b""
        end = len(self.data) if n is None or n < 0 else self.pos + n
        out = self.data[self.pos:end]
        self.pos += len(out)
        return out

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            if offset < 0:
                raise ValueError(f"negative seek value {offset}")
            self.pos = offset
        elif whence == 1:
            self.pos = max(0, self.pos + offset)
        else:
            self.pos = max(0, len(self.data) + offset)
        return self.pos

    def tell(self) -> int:
        return self.pos

    def readline(self) -> bytes:
        if self.pos >= len(self.data):
            return b""
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        out = self.data[self.pos:end]
        self.pos = end
        return out


@dataclass
class Opened:
    """What a PIL opener made of the bytes: its format, PIL mode and
    size, and the loader of its pixels."""
    fmt: str
    mode: str
    size: tuple
    load: Optional[Callable[[], np.ndarray]] = None
    info: dict = field(default_factory=dict)


class DecompressionBombError(Exception):
    """More pixels than PIL opens (PIL's class of the same name)."""


class UnsupportedFormat(NotImplementedError):
    """A format PIL opens that the port does not decode yet."""


def item16(what: str) -> UnsupportedFormat:
    """The refusal of what PIL opens and the port does not decode;
    ``fmt`` names the opener."""
    e = UnsupportedFormat(
        f"unsupported raster format: {what} (PIL opens it; decoding it is "
        "ROADMAP queue 1 item 16)")
    e.fmt = what.split()[0]
    return e


def check_bomb(size) -> None:
    pixels = max(1, size[0]) * max(1, size[1])
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise DecompressionBombError(
            f"Image size ({pixels} pixels) exceeds limit of "
            f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb "
            "DOS attack.")


def i16le(b, o=0):
    return struct.unpack_from("<H", b, o)[0]


def i16be(b, o=0):
    return struct.unpack_from(">H", b, o)[0]


def i32le(b, o=0):
    return struct.unpack_from("<I", b, o)[0]


def i32be(b, o=0):
    return struct.unpack_from(">I", b, o)[0]


def truncated(left: int) -> OSError:
    return OSError(f"image file is truncated ({left} bytes not processed)")


def read_rows(data: bytes, offset: int, stride: int, rows: int,
              row: Optional[int] = None) -> bytes:
    """The bytes of a raw tile of ``rows`` rows ``stride`` apart, each
    ``row`` bytes long (default: the stride), or the OSError PIL's
    loader raises when the file ends first. PIL's raw decoder takes a
    row, then skips to the next: it needs no padding after the last row,
    and what it leaves at the end is the partial row or skip."""
    row = stride if row is None else row
    avail = max(0, len(data) - offset)
    need = stride * (rows - 1) + row
    if avail < need:
        done = avail // stride if stride else 0
        left = avail - done * stride
        if left >= row and stride > row:
            left -= row  # a row read, its skip short
        raise truncated(left)
    out = data[offset:offset + stride * rows]
    return out if len(out) == stride * rows else \
        out + bytes(stride * rows - len(out))


def unpack_oserror(code: int) -> OSError:
    """PIL's ``_get_oserror`` for a decoder's error code."""
    text = {-1: "buffer overrun", -2: "broken data stream",
            -3: "unknown error", -9: "out of memory"}.get(code)
    text = text or f"decoder error {code}"
    return OSError(f"{text} when reading image file")


# --------------------------------------------------------------- unpack

# rawmode -> (bytes a pixel, band order taken from each pixel)
_INTERLEAVED = {
    "L": (1, (0,)), "P": (1, (0,)), "LA": (2, (0, 1)), "PA": (2, (0, 1)),
    "PX": (2, (0,)), "RGB": (3, (0, 1, 2)), "BGR": (3, (2, 1, 0)),
    "RGBX": (4, (0, 1, 2)), "RGBXX": (5, (0, 1, 2)),
    "RGBXXX": (6, (0, 1, 2)), "BGRX": (4, (2, 1, 0)),
    "XBGR": (4, (3, 2, 1)), "BGXR": (4, (3, 1, 0)),
    "RGBA": (4, (0, 1, 2, 3)), "BGRA": (4, (2, 1, 0, 3)),
    "ABGR": (4, (3, 2, 1, 0)), "BGAR": (4, (3, 1, 0, 2)),
    "RGBAX": (5, (0, 1, 2, 3)), "RGBAXX": (6, (0, 1, 2, 3)),
    "CMYK": (4, (0, 1, 2, 3)), "CMYKX": (5, (0, 1, 2, 3)),
    "CMYKXX": (6, (0, 1, 2, 3)), "LAB": (3, (0, 1, 2)),
    "YCbCr": (3, (0, 1, 2)), "L;I": (1, (0,)),
}
# rawmode -> numpy dtype of the samples and the dtype np.asarray gives
_WORDS = {
    "I;16": ("<u2", "<u2"), "I;16L": ("<u2", "<u2"), "I;16B": (">u2", ">u2"),
    "I;16N": ("<u2", "<u2"), "I;16S": ("<i2", "<i4"),
    "I;16BS": (">i2", "<i4"), "I;32": ("<i4", "<i4"),
    "I;32N": ("<i4", "<i4"), "I;32S": ("<i4", "<i4"),
    "I;32BS": (">i4", "<i4"), "F;32F": ("<f4", "<f4"),
    "F;32BF": (">f4", "<f4"),
}
# premultiplied RGBA raw modes -> bytes a pixel
_PREMULTIPLIED = {"RGBa": 4, "RGBaX": 5, "RGBaXX": 6}
_SUBBYTE = {"L;2": (2, 85, False), "L;2I": (2, 85, True),
            "L;4": (4, 17, False), "L;4I": (4, 17, True),
            "P;1": (1, 1, False), "P;2": (2, 1, False),
            "P;4": (4, 1, False)}


def row_bytes(rawmode: str, width: int) -> int:
    """Bytes a row of ``rawmode`` takes (PIL's default stride)."""
    if rawmode in ("1", "1;I", "1;R", "1;IR"):
        return (width + 7) // 8
    if rawmode == "I;12":
        return (width * 12 + 7) // 8
    if rawmode in _PREMULTIPLIED:
        return width * _PREMULTIPLIED[rawmode]
    if rawmode in _SUBBYTE:
        return (width * _SUBBYTE[rawmode][0] + 7) // 8
    if rawmode in _INTERLEAVED:
        return width * _INTERLEAVED[rawmode][0]
    if rawmode in _WORDS:
        return width * np.dtype(_WORDS[rawmode][0]).itemsize
    if rawmode in ("RGB;16L", "RGB;16B"):
        return width * 6
    if rawmode in ("RGBA;16L", "RGBA;16B", "RGBX;16L", "RGBX;16B",
                   "RGBa;16L", "RGBa;16B", "CMYK;16L", "CMYK;16B"):
        return width * 8
    if rawmode in ("RGB;L", "LA;L", "RGBA;L", "RGBX;L", "CMYK;L",
                   "YCbCr;L", "PA;L"):
        return width * _INTERLEAVED[rawmode.split(";")[0]][0]
    raise NotImplementedError(rawmode)


def unpack(rawmode: str, buf: bytes, width: int, height: int,
           stride: Optional[int] = None, flip: bool = False) -> np.ndarray:
    """Rows of ``rawmode`` pixels -> the array of the PIL mode they
    unpack to: 2-D for one band (bool for "1"), else (H, W, B). ``flip``
    is PIL's negative ystep (the first row of the buffer is the last of
    the image)."""
    rb = row_bytes(rawmode, width)
    stride = stride or rb
    raw = np.frombuffer(buf, np.uint8, count=stride * height).reshape(
        height, stride)[:, :rb]
    if flip:
        raw = raw[::-1]
    if rawmode in ("1", "1;I", "1;R", "1;IR"):
        order = "little" if rawmode.endswith("R") else "big"
        bits = np.unpackbits(raw, axis=1, bitorder=order)[:, :width]
        bits = bits.astype(bool)
        return ~bits if "I" in rawmode else bits
    if rawmode in _SUBBYTE:
        bits, scale, invert = _SUBBYTE[rawmode]
        per = 8 // bits
        v = np.zeros((height, rb * per), np.uint8)
        for k in range(per):
            v[:, k::per] = (raw >> (8 - bits * (k + 1))) & ((1 << bits) - 1)
        v = v[:, :width] * np.uint8(scale)
        return (255 - v).astype(np.uint8) if invert else v
    if rawmode == "I;12":
        # 12-bit samples, most significant bits first, rows byte-aligned
        b = np.zeros((height, -(-rb // 3) * 3), np.uint16)
        b[:, :rb] = raw
        t = b.reshape(height, -1, 3)
        v = np.stack([(t[:, :, 0] << 4) | (t[:, :, 1] >> 4),
                      ((t[:, :, 1] & 15) << 8) | t[:, :, 2]], -1)
        return v.reshape(height, -1)[:, :width].astype("<u2")
    if rawmode in _PREMULTIPLIED:
        n = _PREMULTIPLIED[rawmode]
        return unpremultiply(raw.reshape(height, width, n)[:, :, :4])
    if rawmode in _INTERLEAVED:
        n, order = _INTERLEAVED[rawmode]
        px = raw.reshape(height, width, n)[:, :, list(order)]
        if rawmode == "L;I":
            px = 255 - px
        return px[:, :, 0].copy() if len(order) == 1 else px.copy()
    if rawmode in _WORDS:
        src, dst = _WORDS[rawmode]
        v = np.frombuffer(np.ascontiguousarray(raw).tobytes(), src).reshape(
            height, width)
        return v.astype(dst)
    if rawmode in ("RGB;16L", "RGBA;16L", "RGBX;16L", "RGBa;16L",
                   "CMYK;16L", "RGB;16B", "RGBA;16B", "RGBX;16B",
                   "RGBa;16B", "CMYK;16B"):
        n = 3 if rawmode.startswith("RGB;") else 4
        hi = 1 if rawmode.endswith("L") else 0
        px = raw.reshape(height, width, n, 2)[:, :, :, hi]
        if rawmode.startswith("RGBa"):
            return unpremultiply(px)
        return px[:, :, :3].copy() if rawmode.startswith("RGBX") else px.copy()
    if rawmode.endswith(";L"):
        base = rawmode.split(";")[0]
        n, order = _INTERLEAVED[base]
        px = raw.reshape(height, n, width).transpose(0, 2, 1)[:, :, list(
            order)]
        return px.copy()
    raise NotImplementedError(rawmode)


def unpremultiply(px: np.ndarray) -> np.ndarray:
    """PIL's "RGBa" unpacker over (H, W, 4) bytes: colour times 255 over
    alpha, in integers, cut at 255; a pixel of alpha 0 is all zeros."""
    a = px[:, :, 3:4].astype(np.int32)
    c = px[:, :, :3].astype(np.int32) * 255 // np.maximum(a, 1)
    out = np.concatenate([np.minimum(c, 255), a], -1).astype(np.uint8)
    out[px[:, :, 3] == 0] = 0
    return out


def apply_palette(idx: np.ndarray, palette: bytes, order: str = "RGB"
                  ) -> np.ndarray:
    """``convert("RGB")`` of a P image: entries past the palette's end
    are black. ``order`` is the raw palette's layout."""
    n = len(order)
    entries = len(palette) // n
    table = np.zeros((256, 3), np.uint8)
    p = np.frombuffer(palette[:entries * n], np.uint8).reshape(entries, n)
    take = [order.index(c) for c in "RGB"]
    table[:min(entries, 256)] = p[:256, take]
    return table[idx]


def _raw_load(data, offset, rawmode, size, ystep=1):
    """A loader of one raw tile at ``offset`` (PIL's "raw" decoder)."""
    w, h = size

    def load():
        rb = row_bytes(rawmode, w)
        return unpack(rawmode, read_rows(data, offset, rb, h), w, h, rb,
                      flip=ystep < 0)
    return load


# ------------------------------------------------------------------ PPM

_WS = b"\x20\x09\x0a\x0b\x0c\x0d"
_PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
              b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
              b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}


def ppm_accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix.startswith(b"P") and \
        prefix[1] in b"0123456fy"


def _ppm_token(fp: Reader) -> bytes:
    token = b""
    while len(token) <= 10:
        c = fp.read(1)
        if not c:
            break
        elif c in _WS:
            if not token:
                continue
            break
        elif c == b"#":
            while fp.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise ValueError("Reached EOF while reading header")
    elif len(token) > 10:
        raise ValueError(b"Token too long in file header: %s" % token)
    return token


def _bands(mode):
    return {"1": 1, "L": 1, "P": 1, "I": 1, "F": 1, "RGB": 3, "RGBA": 4,
            "CMYK": 4}[mode]


def open_ppm(data: bytes) -> Opened:
    fp = Reader(data)
    magic = b""
    for _ in range(6):
        c = fp.read(1)
        if not c or c in _WS:
            break
        magic += c
    try:
        mode = _PPM_MODES[magic]
    except KeyError:
        raise SyntaxError("not a PPM file")
    size = int(_ppm_token(fp)), int(_ppm_token(fp))
    decoder = "ppm_plain" if magic in (b"P1", b"P2", b"P3") else "raw"
    if mode == "1":
        args = ("1;I",)
    elif mode == "F":
        scale = float(_ppm_token(fp))
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("scale must be finite and non-zero")
        args = ("F;32F" if scale < 0 else "F;32BF", 0, -1)
    else:
        maxval = int(_ppm_token(fp))
        if not 0 < maxval < 65536:
            raise ValueError("maxval must be greater than 0 and less than "
                             "65536")
        if maxval > 255 and mode == "L":
            mode = "I"
        rawmode = "L" if mode == "I" else mode
        if decoder != "ppm_plain":
            if maxval == 65535 and mode == "I":
                rawmode = "I;16B"
            elif maxval != 255:
                decoder = "ppm"
        args = (rawmode,) if decoder == "raw" else (rawmode, maxval)
    offset = fp.tell()
    w, h = size

    def load():
        if decoder == "raw":
            rawmode = args[0]
            if mode in ("RGBA", "CMYK", "P") and rawmode == mode:
                rb = w * _bands(mode)
                buf = read_rows(data, offset, rb, h)
                return np.frombuffer(buf, np.uint8).reshape(h, w, -1).copy() \
                    if mode != "P" else np.frombuffer(
                        buf, np.uint8).reshape(h, w).copy()
            arr = _raw_load(data, offset, rawmode, size,
                            ystep=args[2] if len(args) > 2 else 1)()
            return arr.astype("<i4") if mode == "I" else arr
        if decoder == "ppm":
            return _ppm_scaled(data[offset:], mode, w, h, args[1])
        return _ppm_plain(data[offset:], mode, w, h,
                          args[1] if len(args) > 1 else None)
    return Opened("PPM", mode, size, load)


def _set_as_raw(flat: np.ndarray, n_expected: int) -> np.ndarray:
    if flat.size < n_expected:
        raise ValueError("not enough image data")
    return flat[:n_expected]


def _ppm_scaled(body: bytes, mode, w, h, maxval) -> np.ndarray:
    bands = _bands(mode)
    inb = 1 if maxval < 256 else 2
    out_max = 65535 if mode == "I" else 255
    npx = min(w * h, len(body) // (inb * bands))
    v = np.frombuffer(body[:npx * inb * bands], np.uint8 if inb == 1 else
                      ">u2").astype(np.float64)
    v = np.minimum(out_max, np.round(v / maxval * out_max))
    v = _set_as_raw(v, w * h * bands)
    if mode == "I":
        return v.astype("<i4").reshape(h, w)
    v = v.astype(np.uint8)
    return v.reshape(h, w) if bands == 1 else v.reshape(h, w, bands)


def _ppm_plain(body: bytes, mode, w, h, maxval) -> np.ndarray:
    """PIL's ``PpmPlainDecoder``: comments stripped block by block."""
    blocks = [body[i:i + 65536] for i in range(0, len(body), 65536)]
    spans = [False]

    def ignore_comments(block):
        def comment_end(b, start=0):
            a, c = b.find(b"\n", start), b.find(b"\r", start)
            return min(a, c) if a * c > 0 else max(a, c)
        if spans[0]:
            while block:
                e = comment_end(block)
                if e != -1:
                    block = block[e + 1:]
                    break
                block = blocks.pop(0) if blocks else b""
        spans[0] = False
        while True:
            s = block.find(b"#")
            if s == -1:
                break
            e = comment_end(block, s)
            if e != -1:
                block = block[:s] + block[e + 1:]
            else:
                block = block[:s]
                spans[0] = True
                break
        return block

    if mode == "1":
        total = w * h
        out = bytearray()
        while len(out) != total:
            block = blocks.pop(0) if blocks else b""
            if not block:
                break
            block = ignore_comments(block)
            tokens = b"".join(block.split())
            for t in tokens:
                if t not in (48, 49):
                    raise ValueError(b"Invalid token for this mode: %s"
                                     % bytes([t]))
            out = (out + tokens)[:total]
        flat = np.frombuffer(bytes(out), np.uint8)
        return (_set_as_raw(flat, total) == ord("0")).reshape(h, w)
    bands = _bands(mode)
    out_max = 65535 if mode == "I" else 255
    total = w * h * bands
    values = []
    half = b""
    while len(values) != total:
        block = blocks.pop(0) if blocks else b""
        if not block:
            if half:
                block = b" "
            else:
                break
        block = ignore_comments(block)
        if half:
            block = half + block
            half = b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(b"Token too long found in data: %s"
                                 % half[:11])
        for token in tokens:
            if len(token) > 10:
                raise ValueError(b"Token too long found in data: %s"
                                 % token[:11])
            value = int(token)
            if value < 0:
                raise ValueError(f"Channel value is negative: {value}")
            if value > maxval:
                raise ValueError(
                    f"Channel value too large for this mode: {value}")
            values.append(round(value / maxval * out_max))
            if len(values) == total:
                break
    flat = _set_as_raw(np.asarray(values, np.int64), total)
    if mode == "I":
        return flat.astype("<i4").reshape(h, w)
    flat = flat.astype(np.uint8)
    return flat.reshape(h, w) if bands == 1 else flat.reshape(h, w, bands)


# ------------------------------------------------------------------ TGA

_TGA_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
            (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}


def open_tga(data: bytes) -> Opened:
    fp = Reader(data)
    s = fp.read(18)
    id_len, colormaptype, imagetype = s[0], s[1], s[2]
    depth, flags = s[16], s[17]
    size = i16le(s, 12), i16le(s, 14)
    if (colormaptype not in (0, 1) or size[0] <= 0 or size[1] <= 0
            or depth not in (1, 8, 16, 24, 32)):
        raise SyntaxError("not a TGA file")
    if imagetype in (3, 11):
        mode = "L"
        if depth == 1:
            mode = "1"
        elif depth == 16:
            mode = "LA"
    elif imagetype in (1, 9):
        mode = "P" if colormaptype else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise SyntaxError("unknown TGA mode")
    orientation = flags & 0x30
    flip_h = orientation in (0x10, 0x30)
    if orientation in (0x20, 0x30):
        orientation = 1
    elif orientation in (0, 0x10):
        orientation = -1
    else:
        raise SyntaxError("unknown TGA orientation")
    if id_len:
        fp.read(id_len)
    palette = order = None
    entries = 0
    if colormaptype:
        start, n, mapdepth = i16le(s, 3), i16le(s, 5), s[7]
        if mapdepth not in (16, 24, 32):
            raise SyntaxError("unknown TGA map depth")
        unit = mapdepth // 8
        raw = bytes(unit * start) + fp.read(unit * n)
        entries = len(raw) // unit
        if mapdepth == 16:
            palette, order = _bgra15_palette(raw), "RGB"
        else:
            palette, order = raw, "BGR" if mapdepth == 24 else "BGRA"
    rawmode = _TGA_RAW.get((imagetype & 7, depth))
    offset = fp.tell()
    w, h = size

    def load():
        if entries > 256:
            # putpalette of a colour map of more than 256 entries
            raise ValueError("invalid palette size")
        if rawmode is None:
            raise OSError("cannot load this image")
        if rawmode == "BGRA;15Z":
            rb = 2 * w
        else:
            rb = row_bytes(rawmode, w)
        if imagetype & 8:
            buf = _tga_rle(data, offset, depth, rb * h)
        else:
            buf = read_rows(data, offset, rb, h)
        if rawmode == "BGRA;15Z":
            v = np.frombuffer(buf, "<u2").reshape(h, w)
            arr = np.stack([((v >> 10) & 31) * 255 // 31,
                            ((v >> 5) & 31) * 255 // 31,
                            (v & 31) * 255 // 31,
                            np.where(v & 0x8000, 255, 0)], -1).astype(np.uint8)
            arr = arr[::-1] if orientation < 0 else arr
        else:
            arr = unpack(rawmode, buf, w, h, rb, flip=orientation < 0)
        if flip_h:
            arr = arr[:, ::-1].copy()
        if mode == "P":
            arr = apply_palette(arr, palette, order)
        return arr
    return Opened("TGA", mode, size, load)


def _bgra15_palette(raw: bytes) -> bytes:
    v = np.frombuffer(raw[:len(raw) // 2 * 2], "<u2")
    rgb = np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31,
                    (v & 31) * 255 // 31], -1).astype(np.uint8)
    return rgb.tobytes()


def _tga_rle(data: bytes, offset: int, depth: int, total: int) -> bytes:
    """PIL's ``TgaRleDecode``: packets may cross rows; a packet the data
    does not hold whole is left unprocessed."""
    px = max(1, depth // 8) if depth != 1 else 1
    out = bytearray()
    pos = offset
    end = len(data)
    while len(out) < total:
        if pos >= end:
            raise truncated(0)
        head = data[pos]
        if head & 0x80:
            if end - pos < 1 + px:
                raise truncated(end - pos)
            n = (head & 0x7F) + 1
            out += data[pos + 1:pos + 1 + px] * n
            pos += 1 + px
        else:
            n = (head + 1) * px
            if end - pos < 1 + n:
                raise truncated(end - pos)
            out += data[pos + 1:pos + 1 + n]
            pos += 1 + n
        if len(out) > total:
            raise unpack_oserror(-1)
    return bytes(out)


# ------------------------------------------------------------------ SGI

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
              (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
              (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def sgi_accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and i16be(prefix) == 474


def open_sgi(data: bytes) -> Opened:
    s = data[:512]
    if not sgi_accept(s):
        raise ValueError("Not an SGI image file")
    compression, bpc = s[2], s[3]
    dimension, xsize, ysize, zsize = (i16be(s, 4), i16be(s, 6), i16be(s, 8),
                                      i16be(s, 10))
    try:
        rawmode = _SGI_MODES[(bpc, dimension, zsize)]
    except KeyError:
        raise ValueError("Unsupported SGI image mode")
    mode = rawmode.split(";")[0]
    size = (xsize, ysize)
    nb = len(mode)

    def load():
        if compression == 0:
            pagesize = xsize * ysize * bpc
            if bpc == 2:
                planes = []
                for band in range(nb):
                    chunk = data[512 + band * 2 * xsize * ysize:
                                 512 + (band + 1) * 2 * xsize * ysize]
                    if len(chunk) < 2 * xsize * ysize:
                        raise ValueError("not enough image data")
                    v = np.frombuffer(chunk, np.uint8).reshape(ysize, xsize, 2)
                    planes.append(v[::-1, :, 0])
            else:
                planes = []
                for band in range(nb):
                    off = 512 + band * pagesize
                    buf = read_rows(data, off, xsize, ysize)
                    planes.append(np.frombuffer(buf, np.uint8).reshape(
                        ysize, xsize)[::-1])
        elif compression == 1:
            planes = _sgi_rle(data, xsize, ysize, nb, bpc)
        else:
            raise OSError("cannot load this image")
        return planes[0].copy() if nb == 1 else np.stack(planes, -1)
    return Opened("SGI", mode, size, load)


def _sgi_rle(data: bytes, xsize: int, ysize: int, zsize: int, bpc: int):
    """PIL's ``SgiRleDecode`` (``pil_rle.cc``): the offset and length
    tables, then each row's runs, a length counting runs; a run past the
    row or the data is a buffer overrun, and a row whose last allowed
    run is not a terminator ends the decode there (PIL's image keeps
    zeros below)."""
    out = np.zeros((ysize, xsize * zsize * bpc), np.uint8)
    body = data[512:]
    if _lib().fc_sgi_rle_decode(body, len(body), xsize, ysize, zsize, bpc,
                                out.ctypes.data):
        raise unpack_oserror(-1)
    px = out[::-1].reshape(ysize, xsize, zsize, bpc)[:, :, :, 0]
    return [np.ascontiguousarray(px[:, :, z]) for z in range(zsize)]


# ------------------------------------------------------------------ PCX

def pcx_accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def open_pcx(data: bytes, fmt: str = "PCX", start: int = 0) -> Opened:
    fp = Reader(data, start)
    s = fp.read(68)
    if not pcx_accept(s):
        raise SyntaxError("not a PCX file")
    bbox = i16le(s, 4), i16le(s, 6), i16le(s, 8) + 1, i16le(s, 10) + 1
    if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
        raise SyntaxError("bad PCX image size")
    offset = fp.tell() + 60
    version, bits, planes = s[1], s[3], s[65]
    provided_stride = i16le(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = s[16:64]
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        fp.seek(-769, 2)
        tail = fp.read(769)
        if len(tail) == 769 and tail[0] == 12:
            for i in range(256):
                if tail[i * 3 + 1:i * 3 + 4] != bytes([i]) * 3:
                    mode = rawmode = "P"
                    break
            if mode == "P":
                palette = tail[1:]
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise OSError("unknown PCX mode")
    size = bbox[2] - bbox[0], bbox[3] - bbox[1]
    stride = (size[0] * bits + 7) // 8
    if provided_stride != stride:
        stride += stride % 2

    def load():
        lines = _pcx_decode(data, offset, planes * stride, size[1])
        return _pcx_unpack(lines, rawmode, size, planes * stride, palette)
    return Opened(fmt, mode, size, load)


def _pcx_decode(data: bytes, offset: int, nbytes: int, ysize: int):
    """PIL's ``PcxDecode``: (ysize, nbytes) line buffers (``pil_rle.cc``)."""
    out = np.zeros((ysize, nbytes), np.uint8)
    left = np.zeros(1, np.int32)
    rc = _lib().fc_pcx_decode(data, len(data), offset, nbytes, ysize,
                              out.ctypes.data, left.ctypes.data)
    if rc == 1:
        raise truncated(int(left[0]))
    if rc:
        raise unpack_oserror(-1)
    return out


def _pcx_unpack(lines, rawmode, size, nbytes, palette):
    w, h = size
    if nbytes % w and nbytes > w:
        bands = nbytes // w
        stride = nbytes // bands
        for i in range(1, bands):
            src = lines[:, i * stride:i * stride + w].copy()
            lines[:, i * w:(i + 1) * w] = src
    if rawmode == "1":
        return np.unpackbits(lines, axis=1)[:, :w].astype(bool)
    if rawmode in ("L", "P"):
        arr = lines[:, :w].copy()
        return apply_palette(arr, palette) if rawmode == "P" else arr
    if rawmode == "RGB;L":
        return lines[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1).copy()
    planes = int(rawmode[2])
    s = (w + 7) // 8
    idx = np.zeros((h, w), np.uint8)
    for p in range(planes):
        bits = np.unpackbits(lines[:, p * s:(p + 1) * s], axis=1)[:, :w]
        idx |= (bits << p).astype(np.uint8)
    return apply_palette(idx, palette)


# ------------------------------------------------------------------ QOI

def open_qoi(data: bytes) -> Opened:
    fp = Reader(data)
    if not fp.read(4).startswith(b"qoif"):
        raise SyntaxError("not a QOI file")
    size = i32be(fp.read(4)), i32be(fp.read(4))
    channels = fp.read(1)[0]
    mode = "RGB" if channels == 3 else "RGBA"
    offset = 14

    def load():
        return _qoi_decode(data, offset, size, 3 if mode == "RGB" else 4)
    return Opened("QOI", mode, size, load)


def _qoi_decode(data, offset, size, bands):
    """PIL's Python ``QoiDecoder``, step for step (``pil_rle.cc``): its
    reads past the end raise the IndexError or ValueError they raise
    there."""
    out = np.empty((size[1], size[0], bands), np.uint8)
    got = np.zeros(1, np.int32)
    rc = _lib().fc_qoi_decode(data, len(data), offset, size[0] * size[1],
                              bands, out.ctypes.data, got.ctypes.data)
    if rc == 1:
        raise IndexError("index out of range")
    if rc:
        raise ValueError(f"not enough values to unpack (expected 4, got "
                         f"{int(got[0])})")
    return out


# ------------------------------------------------------------------- IM

_IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = ("F", f"F;{_i}")
    _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = (f"I;{_i}", f"I;{_i}")
    _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_IM_OPEN["L 32S image"] = ("I", "I;32S")
_IM_OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    _IM_OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {"Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type"}


def _im_number(s):
    try:
        return int(s)
    except ValueError:
        return float(s)


def open_im(data: bytes) -> Opened:
    fp = Reader(data)
    if b"\n" not in fp.read(100):
        raise SyntaxError("not an IM file")
    fp.seek(0)
    n = 0
    info = {"Image type": "L", "Image size (x*y)": (512, 512),
            "File size (no of images)": 1}
    rawmode = "L"
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _IM_SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header: "
                              + s.decode("ascii", "replace"))
        k, v = m.group(1, 2)
        k = k.decode("latin-1", "replace")
        v = v.decode("latin-1", "replace")
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = tuple(map(_im_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        if k in _IM_TAGS:
            n += 1
    if not n:
        raise SyntaxError("Not an IM file")
    size = info["Image size (x*y)"]
    mode = info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("File truncated")
    palette = None
    if "Lut" in info:
        pal = fp.read(768)
        grey = linear = True
        for i in range(256):
            if pal[i] == pal[i + 256] == pal[i + 512]:
                if pal[i] != i:
                    linear = False
            else:
                grey = False
        if mode in ("L", "LA", "P", "PA"):
            if not grey:
                if mode in ("L", "P"):
                    mode = rawmode = "P"
                elif mode in ("LA", "PA"):
                    mode, rawmode = "PA", "PA;L"
                palette = pal
    offset = fp.tell()
    # the checks ImageFile makes after _open, on what _open left
    if not isinstance(size, tuple) or len(size) != 2:
        raise TypeError("size")
    if not isinstance(mode, str) or not mode:
        raise SyntaxError("not identified by this opener")
    w, h = size

    def load():
        if mode not in _PIL_MODES:
            raise ValueError("unrecognized image mode")
        if (mode, rawmode) not in _IM_PAIRS:
            raise ValueError("unknown raw mode for given image mode")
        if rawmode in ("RGB;T", "RYB;T", "RLB") or (
                rawmode.startswith("F;") and rawmode not in ("F;32F",)) or \
                rawmode == "I;32":
            raise UnsupportedIM(rawmode)
        if mode == "P" and palette is not None:
            rb = w
            buf = read_rows(data, offset, rb, h)
            idx = np.frombuffer(buf, np.uint8).reshape(h, w)[::-1]
            # palette stored as three planes (rawmode "RGB;L")
            pal = np.frombuffer(palette.ljust(768, b"\0"), np.uint8).reshape(
                3, 256).T.tobytes()
            return apply_palette(idx, pal)
        if mode == "PA":
            return unpack("PA;L", read_rows(data, offset, 2 * w, h), w, h,
                          flip=True)
        return _raw_load(data, offset, rawmode, size, ystep=-1)()
    return Opened("IM", mode, size, load)


# the modes Image.core.new takes, and the raw modes an IM header can
# pair with them
_PIL_MODES = {"1", "CMYK", "F", "HSV", "I", "I;16", "I;16B", "I;16L",
              "I;16N", "L", "LA", "La", "LAB", "P", "PA", "RGB", "RGBA",
              "RGBX", "RGBa", "YCbCr"}
_IM_PAIRS = set(_IM_OPEN.values()) | {("L", "L"), ("P", "P"),
                                      ("PA", "PA;L")}


class UnsupportedIM(NotImplementedError):
    """An IM raw mode the port does not unpack."""


# ------------------------------------------------------------------ GBR

def gbr_accept(prefix: bytes) -> bool:
    return len(prefix) >= 8 and i32be(prefix, 0) >= 20 and \
        i32be(prefix, 4) in (1, 2)


def open_gbr(data: bytes) -> Opened:
    """GIMP brushes (GbrImagePlugin): L or RGBA, raw after the header."""
    fp = Reader(data)
    header_size = i32be(fp.read(4))
    if header_size < 20:
        raise SyntaxError("not a GIMP brush")
    version = i32be(fp.read(4))
    if version not in (1, 2):
        raise SyntaxError(f"Unsupported GIMP brush version: {version}")
    width, height = i32be(fp.read(4)), i32be(fp.read(4))
    depth = i32be(fp.read(4))
    if width <= 0 or height <= 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError(f"Unsupported GIMP brush color depth: {depth}")
    if version == 1:
        comment_length = header_size - 20
    else:
        comment_length = header_size - 28
        if fp.read(4) != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        i32be(fp.read(4))
    fp.read(comment_length)
    check_bomb((width, height))
    offset = fp.tell()

    def load():
        body = data[offset:offset + width * height * depth]
        if len(body) < width * height * depth:
            raise ValueError("not enough image data")
        px = np.frombuffer(body, np.uint8)
        return px.reshape(height, width).copy() if depth == 1 else \
            px.reshape(height, width, 4).copy()
    return Opened("GBR", "L" if depth == 1 else "RGBA", (width, height), load)


# ------------------------------------------------------------------ XBM

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def xbm_accept(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


def open_xbm(data: bytes) -> Opened:
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise SyntaxError("not a XBM file")
    size = int(m.group("width")), int(m.group("height"))
    offset = m.end()

    def load():
        return _xbm_decode(data, offset, size)
    return Opened("XBM", "1", size, load)


_HEX = [0] * 256
for _c in b"0123456789":
    _HEX[_c] = _c - 48
for _c in b"abcdef":
    _HEX[_c] = _c - 87
for _c in b"ABCDEF":
    _HEX[_c] = _c - 55


def _xbm_decode(data, offset, size):
    """PIL's ``XbmDecode``: skip to each "x", take the two characters
    after it as hex digits (others count 0; a byte, least significant bit
    first), a row of ceil(w/8) bytes; data that ends first leaves its
    unread bytes unprocessed."""
    w, h = size
    per_row = (w + 7) // 8
    out = bytearray()
    pos, end = offset, len(data)
    need = per_row * h
    while len(out) < need:
        while True:
            if pos >= end:
                raise truncated(0)
            if data[pos] == ord("x"):
                break
            pos += 1
        if end - pos < 3:
            raise truncated(end - pos)
        out.append(_HEX[data[pos + 1]] << 4 | _HEX[data[pos + 2]])
        pos += 3
    bits = np.unpackbits(np.frombuffer(bytes(out), np.uint8).reshape(
        h, per_row), axis=1, bitorder="little")[:, :w]
    return bits.astype(bool)


# ------------------------------------------------------------------ DDS

_DDPF_ALPHAPIXELS, _DDPF_FOURCC = 0x1, 0x4
_DDPF_PALETTEINDEXED8, _DDPF_RGB, _DDPF_LUMINANCE = 0x20, 0x40, 0x20000


def _fourcc(s: bytes) -> int:
    return struct.unpack("<I", s)[0]


_BC = {_fourcc(b"DXT1"): ("RGBA", 1, "DXT1"), _fourcc(b"DXT3"): (
    "RGBA", 2, "DXT3"), _fourcc(b"DXT5"): ("RGBA", 3, "DXT5"),
    _fourcc(b"BC4U"): ("L", 4, "BC4"), _fourcc(b"ATI1"): ("L", 4, "BC4"),
    _fourcc(b"BC5S"): ("RGB", 5, "BC5S"), _fourcc(b"BC5U"): ("RGB", 5, "BC5"),
    _fourcc(b"ATI2"): ("RGB", 5, "BC5")}
_DXGI = {70: ("RGBA", 1, "BC1"), 71: ("RGBA", 1, "BC1"),
         73: ("RGBA", 2, "BC2"), 74: ("RGBA", 2, "BC2"),
         76: ("RGBA", 3, "BC3"), 77: ("RGBA", 3, "BC3"),
         79: ("L", 4, "BC4"), 80: ("L", 4, "BC4"),
         82: ("RGB", 5, "BC5"), 83: ("RGB", 5, "BC5"),
         84: ("RGB", 5, "BC5S"), 95: ("RGB", 6, "BC6H"),
         96: ("RGB", 6, "BC6HS"), 97: ("RGBA", 7, "BC7"),
         98: ("RGBA", 7, "BC7"), 99: ("RGBA", 7, "BC7"),
         27: ("RGBA", 0, None), 28: ("RGBA", 0, None), 29: ("RGBA", 0, None)}


class UnsupportedDDS(NotImplementedError):
    """A DDS block format PIL decodes that the port does not (BC6H,
    BC7)."""


def open_dds(data: bytes) -> Opened:
    fp = Reader(data)
    if not fp.read(4).startswith(b"DDS "):
        raise SyntaxError("not a DDS file")
    (header_size,) = struct.unpack("<I", fp.read(4))
    if header_size != 124:
        raise OSError(f"Unsupported header size {header_size!r}")
    header = fp.read(header_size - 4)
    if len(header) != 120:
        raise OSError(f"Incomplete header: {len(header)} bytes")
    flags, height, width = struct.unpack("<3I", header[:12])
    size = (width, height)
    pfsize, pfflags, fourcc, bitcount = struct.unpack("<4I", header[68:84])
    n, fmt = 0, None
    palette = None
    if pfflags & _DDPF_RGB:
        mode = "RGBA" if pfflags & _DDPF_ALPHAPIXELS else "RGB"
        masks = struct.unpack(f"<{len(mode)}I",
                              header[84:84 + len(mode) * 4])
        pos = fp.tell()

        def load():
            return _dds_rgb(data, pos, size, bitcount, masks)
        return Opened("DDS", mode, size, load)
    elif pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            mode = "LA"
        else:
            raise OSError(f"Unsupported bitcount {bitcount} for {pfflags}")
    elif pfflags & _DDPF_PALETTEINDEXED8:
        mode = "P"
        palette = fp.read(1024)
    elif pfflags & _DDPF_FOURCC:
        if fourcc in _BC:
            mode, n, fmt = _BC[fourcc]
        elif fourcc == _fourcc(b"DX10"):
            (dxgi,) = struct.unpack("<I", fp.read(4))
            fp.read(16)
            if dxgi not in _DXGI:
                raise NotImplementedError(f"Unimplemented DXGI format {dxgi}")
            mode, n, fmt = _DXGI[dxgi]
        else:
            raise NotImplementedError(
                f"Unimplemented pixel format {fourcc!r}")
    else:
        raise NotImplementedError(f"Unknown pixel format flags {pfflags}")
    pos = fp.tell()
    w, h = size

    def load():
        if n in (6, 7):
            raise UnsupportedDDS(fmt)
        if n:
            return _bcn(data, pos, size, n, fmt)
        rb = w * len(mode) if mode != "P" else w
        buf = read_rows(data, pos, rb, h)
        arr = np.frombuffer(buf, np.uint8).reshape(h, w, -1)
        if mode == "P":
            return apply_palette(arr[:, :, 0], palette, "RGBA")
        return arr[:, :, 0].copy() if mode == "L" else arr.copy()
    return Opened("DDS", mode, size, load)


def _dds_rgb(data, pos, size, bitcount, masks):
    """PIL's Python ``DdsRgbDecoder``: a short read decodes as zeros."""
    w, h = size
    bytecount = bitcount // 8
    offsets, totals = [], []
    for mask in masks:
        off = 0
        if mask != 0:
            while mask >> (off + 1) << (off + 1) == mask:
                off += 1
        offsets.append(off)
        totals.append(mask >> off)
    npx = w * h
    raw = data[pos:pos + npx * bytecount] if bytecount else b""
    vals = np.zeros(npx, np.uint64)
    if bytecount:
        full = len(raw) // bytecount
        b = np.frombuffer(raw[:full * bytecount], np.uint8).reshape(
            full, bytecount).astype(np.uint64)
        v = np.zeros(full, np.uint64)
        for k in range(bytecount):
            v |= b[:, k] << np.uint64(8 * k)
        vals[:full] = v
        rest = raw[full * bytecount:]
        if rest and full < npx:
            vals[full] = int.from_bytes(rest, "little")
    out = np.zeros((npx, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        if totals[i]:
            m = (vals & np.uint64(mask)) >> np.uint64(offsets[i])
            out[:, i] = ((m.astype(np.float64) / totals[i]) * 255).astype(
                np.int64)
    return out.reshape(h, w, len(masks))


def _rgb565(c):
    r = (c >> 11) & 31
    g = (c >> 5) & 63
    b = c & 31
    return ((r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2))


def _bc1_colors(block, out_alpha):
    """(16, 4) RGBA of a BC1 colour block, as PIL's ``decode_bc1_color``."""
    c0, c1 = struct.unpack_from("<HH", block, 0)
    (lut,) = struct.unpack_from("<I", block, 4)
    p0 = _rgb565(c0)
    p1 = _rgb565(c1)
    cols = [p0 + (255,), p1 + (255,)]
    if c0 > c1 or not out_alpha:
        cols.append(tuple((2 * a + b) // 3 for a, b in zip(p0, p1)) + (255,))
        cols.append(tuple((a + 2 * b) // 3 for a, b in zip(p0, p1)) + (255,))
    else:
        cols.append(tuple((a + b) // 2 for a, b in zip(p0, p1)) + (255,))
        cols.append((0, 0, 0, 0))
    return [cols[(lut >> (2 * i)) & 3] for i in range(16)]


def _bc3_alpha(block, o):
    a0, a1 = block[o], block[o + 1]
    bits = int.from_bytes(block[o + 2:o + 8], "little")
    lut = [a0, a1]
    if a0 > a1:
        lut += [((8 - i) * a0 + (i - 1) * a1) // 7 for i in range(2, 8)]
    else:
        lut += [((6 - i) * a0 + (i - 1) * a1) // 5 for i in range(2, 6)]
        lut += [0, 255]
    return [lut[(bits >> (3 * i)) & 7] for i in range(16)]


def _bc4_channel(block, o, signed):
    if not signed:
        return _bc3_alpha(block, o)
    a0, a1 = struct.unpack_from("<bb", block, o)
    bits = int.from_bytes(block[o + 2:o + 8], "little")
    lut = [a0, a1]
    if a0 > a1:
        lut += [((8 - i) * a0 + (i - 1) * a1) // 7 for i in range(2, 8)]
    else:
        lut += [((6 - i) * a0 + (i - 1) * a1) // 5 for i in range(2, 6)]
        lut += [-128, 127]
    return [(lut[(bits >> (3 * i)) & 7] + 128) & 255 for i in range(16)]


def _bcn(data, pos, size, n, fmt):
    """PIL's ``bcn`` decoder (``BcnDecode.c``) for BC1-BC5: 4x4 blocks
    left to right, top to bottom, clipped at the image's edge; the data
    must hold every block."""
    w, h = size
    bsize = 8 if n in (1, 4) else 16
    bw, bh = (w + 3) // 4, (h + 3) // 4
    need = bw * bh * bsize
    avail = max(0, len(data) - pos)
    if avail < need:
        # the decoder takes whole rows of blocks' worth of bytes per call
        raise truncated(avail % (bw * bsize) if bw * bsize else avail)
    bands = {1: 4, 2: 4, 3: 4, 4: 1, 5: 3}[n]
    out = np.zeros((bh * 4, bw * 4, bands), np.uint8)
    for by in range(bh):
        for bx in range(bw):
            o = pos + (by * bw + bx) * bsize
            blk = data[o:o + bsize]
            if n == 1:
                px = _bc1_colors(blk, True)
            elif n == 2:
                alpha = int.from_bytes(blk[:8], "little")
                cols = _bc1_colors(blk[8:], False)
                px = [c[:3] + ((((alpha >> (4 * i)) & 15) * 17),)
                      for i, c in enumerate(cols)]
            elif n == 3:
                a = _bc3_alpha(blk, 0)
                cols = _bc1_colors(blk[8:], False)
                px = [c[:3] + (a[i],) for i, c in enumerate(cols)]
            elif n == 4:
                px = [(v,) for v in _bc4_channel(blk, 0, False)]
            else:
                signed = fmt == "BC5S"
                r = _bc4_channel(blk, 0, signed)
                g = _bc4_channel(blk, 8, signed)
                px = [(r[i], g[i], 0) for i in range(16)]
            out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = np.asarray(
                px, np.uint8).reshape(4, 4, bands)
    out = out[:h, :w]
    return out[:, :, 0].copy() if bands == 1 else out.copy()
