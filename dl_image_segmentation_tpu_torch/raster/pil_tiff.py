"""TIFF as PIL 12.1 reads it (``TiffImagePlugin``), on the port's own
codecs: the first page, in PIL's modes.

The header and the first IFD are read as ``ImageFileDirectory_v2``
reads them (a tag of an unknown type or of no data is skipped, a tag
whose data lies past the end stops the directory there, the last of
duplicated tags counts; BYTE and UNDEFINED values are bytes, ASCII a
str, rationals numbers), then ``_setup`` picks the mode from PIL's
``OPEN_INFO`` table: (byte order, photometric, sample format, fill
order, bits per sample, extra samples) -> (mode, raw mode). What the
table lacks is PIL's ``SyntaxError`` "unknown pixel mode", which sends
the bytes on to the next opener. So 1-bit images decode to bool,
MinIsWhite is inverted, palette images expand to RGB, 16-bit grey keeps
its byte order (``<u2``, or ``>u2`` for a big-endian file), signed
16-bit and 32-bit grey are int32, float is float32, LA has 2 bands and
CMYK 4; 16-bit RGB is PIL's 8-bit RGB (the high bytes).

Uncompressed files are read as PIL's raw decoder reads them, strip by
strip (``OSError`` "image file is truncated" when the data ends
first; separate planes through the one-letter band unpackers PIL picks).
Compressed ones go through libtiff 4.7 in PIL, as its ``TiffDecode.c``
reads them, on the directory as libtiff reads it again
(``libtiff_dir.py``: tag by tag, what it ignores, pads, estimates and
refuses): strips or tiles in its order into one buffer it keeps, LZW,
Deflate and PackBits (``geotiff.py``'s), zstd (``storage/zstd.py``, the
port's own decoder, as libtiff streams a strip), LZMA (the stdlib's
``lzma``, keeping what liblzma wrote before an error as libtiff does),
ThunderScan, CCITT Modified Huffman, Group 3 and Group 4
(``csrc/host/ccitt.cc``, libtiff's ``tif_fax3.c`` step for step), and
JPEG (compression 7) through the port's ``jpeg.cc``, each strip or tile
with the file's ``JPEGTables``, converted from YCbCr to RGB by the JPEG
decoder as PIL asks libtiff to (``JPEGCOLORMODE_RGB``). Predictors are
undone for the codecs libtiff gives them to; FillOrder 2 reverses the
raw bits; 12-bit grey unpacks to PIL's I;16. Separate planes go plane by
plane into the bytes of PIL's pixel (an RGBa image is unpremultiplied
after). YCbCr in any other form goes through libtiff's RGBA reader
(subsampled blocks, its fixed-point conversion). Where libtiff fails,
PIL's ``OSError`` "decoder error -2"; so for WebP (PIL 12.1's libtiff is
built without it) and SGILog (no mode of PIL's). Old-style JPEG
(compression 6) raises :class:`UnsupportedFormat` naming ROADMAP queue 1
item 16. The EXIF orientation is applied as ``ImageOps.exif_transpose``
does.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from fractions import Fraction

import numpy as np

from .. import _build
from ..storage import zstd
from . import libtiff_dir
from .geotiff import _packbits_decode, _undo_fpredictor, _undo_hpredictor
from .jpeg import JPEGUnsupported, decode_jpeg_array, jpeg_frame
from .lzw import lzw_decode_native
from .pil_formats import (Opened, apply_palette, check_bomb, item16,
                          read_rows, row_bytes, unpack, unpremultiply)

__all__ = ["open_tiff"]

_II, _MM = b"II", b"MM"
_OPEN_INFO = {}


def _info(photo, fmt, fill, bps, extra, mode, rawmode, orders=(_II, _MM)):
    for o in orders:
        _OPEN_INFO[(o, photo, fmt, fill, bps, extra)] = (mode, rawmode)


for _f, _r in ((1, ""), (2, "R")):
    _info(0, (1,), _f, (1,), (), "1", "1;I" + _r)
    _info(1, (1,), _f, (1,), (), "1", "1" + (";R" if _r else ""))
    _info(0, (1,), _f, (2,), (), "L", "L;2I" + _r)
    _info(1, (1,), _f, (2,), (), "L", "L;2" + _r)
    _info(0, (1,), _f, (4,), (), "L", "L;4I" + _r)
    _info(1, (1,), _f, (4,), (), "L", "L;4" + _r)
    _info(0, (1,), _f, (8,), (), "L", "L;I" + _r)
    _info(1, (1,), _f, (8,), (), "L", "L" + (";R" if _r else ""))
    _info(3, (1,), _f, (1,), (), "P", "P;1" + _r)
    _info(3, (1,), _f, (2,), (), "P", "P;2" + _r)
    _info(3, (1,), _f, (4,), (), "P", "P;4" + _r)
    _info(2, (1,), _f, (8, 8, 8), (), "RGB", "RGB" + (";R" if _r else ""))
_info(1, (2,), 1, (8,), (), "L", "L")
_info(1, (1,), 1, (12,), (), "I;16", "I;12", (_II,))
_info(0, (1,), 1, (16,), (), "I;16", "I;16", (_II,))
_info(1, (1,), 1, (16,), (), "I;16", "I;16", (_II,))
_info(1, (1,), 1, (16,), (), "I;16B", "I;16B", (_MM,))
_info(1, (1,), 2, (16,), (), "I;16", "I;16R", (_II,))
_info(1, (2,), 1, (16,), (), "I", "I;16S", (_II,))
_info(1, (2,), 1, (16,), (), "I", "I;16BS", (_MM,))
_info(0, (3,), 1, (32,), (), "F", "F;32F", (_II,))
_info(0, (3,), 1, (32,), (), "F", "F;32BF", (_MM,))
_info(1, (1,), 1, (32,), (), "I", "I;32N", (_II,))
_info(1, (2,), 1, (32,), (), "I", "I;32S", (_II,))
_info(1, (2,), 1, (32,), (), "I", "I;32BS", (_MM,))
_info(1, (3,), 1, (32,), (), "F", "F;32F", (_II,))
_info(1, (3,), 1, (32,), (), "F", "F;32BF", (_MM,))
_info(1, (1,), 1, (8, 8), (2,), "LA", "LA")
for _n, _x in ((4, ()), (4, (0,)), (5, (0, 0)), (6, (0, 0, 0))):
    _info(2, (1,), 1, (8,) * _n, _x, "RGBA" if not _x else "RGB",
          "RGBA" if not _x else "RGB" + "X" * len(_x))
for _x, _r in (((1,), "RGBa"), ((1, 0), "RGBaX"), ((1, 0, 0), "RGBaXX"),
               ((2,), "RGBA"), ((2, 0), "RGBAX"), ((2, 0, 0), "RGBAXX"),
               ((999,), "RGBA")):
    _info(2, (1,), 1, (8,) * (3 + len(_x)), _x, "RGBA", _r)
_info(2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16L", (_II,))
_info(2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16B", (_MM,))
for _x, _m, _r in (((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"),
                   ((1,), "RGBA", "RGBa"), ((2,), "RGBA", "RGBA")):
    _info(2, (1,), 1, (16,) * 4, _x, _m, _r + ";16L", (_II,))
    _info(2, (1,), 1, (16,) * 4, _x, _m, _r + ";16B", (_MM,))
_info(3, (1,), 1, (8,), (), "P", "P")
_info(3, (1,), 1, (8, 8), (0,), "P", "PX")
_info(3, (1,), 1, (8, 8), (2,), "PA", "PA")
_info(3, (1,), 2, (8,), (), "P", "P;R")
_info(5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK")
_info(5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX")
_info(5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX")
_info(5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16L", (_II,))
_info(5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16B", (_MM,))
_info(6, (1,), 1, (8,), (), "L", "L")
_info(6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX")
_info(8, (1,), 1, (8, 8, 8), (), "LAB", "LAB")

_COMPRESSION = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                32773: "packbits", 32809: "tiff_thunderscan",
                32946: "tiff_deflate", 34676: "tiff_sgilog",
                34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                50001: "webp"}
# type -> (struct code, size): the types PIL's directory reads
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("L", 4), 5: ("L", 8),
          6: ("b", 1), 7: ("s", 1), 8: ("h", 2), 9: ("l", 4), 10: ("l", 8),
          11: ("f", 4), 12: ("d", 8), 13: ("L", 4), 16: ("Q", 8)}
# TiffTags.TAGS_V2's value counts: the tags of one value, and those of
# another fixed or variable count; a tag it does not list has none
_PIL_ONE = {
    254, 255, 256, 257, 259, 262, 263, 264, 265, 266, 269, 270, 271, 272,
    274, 277, 278, 282, 283, 284, 285, 286, 287, 288, 289, 290, 292, 293,
    296, 305, 306, 315, 316, 317, 322, 323, 332, 333, 334, 337, 347, 512,
    513, 514, 515, 531, 32995, 32997, 32998, 33432, 33723, 34665, 34675,
    34853, 36864, 37724, 40960, 40965, 41730, 45056, 45057, 45058, 45060,
    45313, 45569, 45570, 45571, 45572, 45573, 45574, 45575, 45576, 45577,
    45578, 45579, 45580, 45581, 50741, 50780, 50839}
_PIL_MANY = {
    258, 273, 279, 280, 281, 291, 301, 320, 324, 325, 330, 336, 338, 339,
    340, 341, 517, 518, 519, 520, 521, 700, 32996, 34377, 45059, 50838, 297,
    318, 321, 530, 319, 342, 532, 529}
_MAX_SAMPLES = 6  # TiffImagePlugin.MAX_SAMPLESPERPIXEL


class IFDRational(Fraction):
    """A RATIONAL value as ``tag_v2`` gives it (PIL's class of the same
    name): not an int, its arithmetic a ``Fraction``'s."""


class _NaNRational(float):
    """PIL's IFDRational over a zero denominator: a NaN, its arithmetic a
    float's."""


_NaNRational.__name__ = "IFDRational"


class _Tags:
    """``ImageFileDirectory_v2`` after ``load``: each tag's type and bytes,
    and its value as ``tag_v2`` gives it. BYTE and UNDEFINED data are
    bytes, ASCII a str, rationals numbers; a tag of one value (or of BYTE
    type, or an unlisted tag with one value) is that value, any other a
    tuple."""

    def __init__(self, raw: dict, e: str):
        self.raw, self.e = raw, e

    def __contains__(self, tag) -> bool:
        return tag in self.raw

    def __getitem__(self, tag):
        typ, body = self.raw[tag]
        if typ in (1, 7):
            value = body
        elif typ == 2:
            value = (body[:-1] if body.endswith(b"\0") else body).decode(
                "latin-1", "replace")
        elif typ in (5, 10):
            v = struct.unpack(self.e + _TYPES[typ][0] * (len(body) // 4),
                              body)
            value = tuple(IFDRational(v[k], v[k + 1]) if v[k + 1] else
                          _NaNRational("nan") for k in range(0, len(v), 2))
        else:
            code, unit = _TYPES[typ]
            value = struct.unpack(self.e + code * (len(body) // unit), body)
        values = (value,) if isinstance(value, (bytes, str)) else value
        if tag in _PIL_ONE or typ == 1 or (tag not in _PIL_MANY
                                           and len(values) == 1):
            return values[0]  # PIL warns of the rest and keeps the first
        return tuple(values)

    def get(self, tag, default=None):
        return self[tag] if tag in self.raw else default


def _load_ifd(data: bytes, offset: int, e: str, big: bool) -> _Tags:
    """ImageFileDirectory_v2.load: the entries of an unknown type are
    skipped, and so are those of no data; a short read of the entries or
    of a tag's data stops the directory (PIL warns and keeps what it
    read). Of duplicated tags the last counts."""
    raw = {}
    head, size, cnt = ("HHQ8s", 20, "Q") if big else ("HHL4s", 12, "H")
    inline = 8 if big else 4
    p = offset + struct.calcsize(cnt)
    if p > len(data):
        return _Tags(raw, e)
    (n,) = struct.unpack(e + cnt, data[offset:p])
    for _ in range(n):
        if p + size > len(data):
            break
        tag, typ, count, fld = struct.unpack(e + head, data[p:p + size])
        p += size
        if typ not in _TYPES:
            continue
        need = count * _TYPES[typ][1]
        if need > inline:
            (at,) = struct.unpack(e + ("Q" if big else "L"), fld)
            body = data[at:at + need]
            if len(body) < need:
                break  # ImageFile._safe_read's OSError
        else:
            body = fld[:need]
        if body:
            raw[tag] = (typ, body)
    return _Tags(raw, e)


def open_tiff(data: bytes) -> Opened:
    ifh = data[:8]
    if ifh[2] == 43:
        ifh += data[8:16]
    if ifh[:4] not in (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
                       b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00"):
        raise SyntaxError("not a TIFF file")
    order = ifh[:2]
    e = "<" if order == _II else ">"
    big = ifh[2] == 43
    (first,) = struct.unpack(e + ("Q" if big else "L"),
                             ifh[8:16] if big else ifh[4:8])
    if not first:
        raise EOFError("no more images in TIFF file")
    if first >= 2 ** 63:
        raise ValueError("Unable to seek to frame")
    tags = _load_ifd(data, first, e, big)
    return _setup(data, tags, order, (first, e, big))


def _setup(data: bytes, tags: _Tags, order: bytes, ifd) -> Opened:
    """TiffImageFile._setup: the mode and raw mode from PIL's own reading
    of the directory; libtiff reads it again to decode a compressed
    file."""
    if 0xBC01 in tags:
        raise OSError("Windows Media Photo files not yet supported")
    compression = _COMPRESSION[tags.get(259, 1)]
    planar = tags.get(284, 1)
    photo = tags.get(262, 0)
    if compression == "tiff_jpeg":
        photo = 6
    fill = tags.get(266, 1)
    try:
        xsize, ysize = tags[256], tags[257]
    except KeyError as err:
        raise TypeError("Missing dimensions") from err
    if not isinstance(xsize, int) or not isinstance(ysize, int):
        raise ValueError("Invalid dimensions")
    orientation = tags.get(274)
    size = (ysize, xsize) if orientation in (5, 6, 7, 8) else (xsize, ysize)
    fmt = tags.get(339, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + \
        len(extra)
    spp = tags.get(277, 3 if compression == "tiff_jpeg" and photo in (2, 6)
                   else 1)
    if spp > _MAX_SAMPLES:
        raise SyntaxError("Invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise SyntaxError("unknown data organization")
    key = (order, photo, fmt, fill, bps, extra)
    try:
        mode, rawmode = _OPEN_INFO[key]
    except KeyError as err:
        raise SyntaxError("unknown pixel mode") from err
    # PIL's dpi from a resolution in centimetres: a TypeError for a text
    # or byte value
    xres, yres = tags.get(282, 1), tags.get(283, 1)
    if xres and yres and tags.get(296) == 3 and (
            isinstance(xres, (bytes, str)) or isinstance(yres, (bytes, str))):
        raise TypeError("can't multiply sequence by non-int of type 'float'")
    libtiff = compression != "raw"
    if libtiff:
        if fill == 2:
            mode, rawmode = _OPEN_INFO[key[:3] + (1,) + key[4:]]
        if photo == 6 and compression == "jpeg" and planar == 1:
            rawmode = "RGB"
        elif rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
    elif 273 not in tags and 324 not in tags:
        raise SyntaxError("unknown data organization")
    else:
        raw_tiles = _raw_tiles(tags, rawmode, xsize, ysize, planar, bps,
                               bps_count)
    palette = None
    if mode in ("P", "PA"):
        palette = bytes(b // 256 & 255 for b in tags[320])  # "RGB;L"
    w, h = xsize, ysize

    def load():
        check_bomb((w, h))
        if libtiff:
            arr = _load_libtiff(data, ifd, compression, mode, rawmode,
                                (w, h))
        else:
            arr = _load_raw(data, raw_tiles, mode, (w, h), planar, bps)
        if mode in ("P",):
            n = len(palette) // 3
            pal = np.frombuffer(palette[:3 * n], np.uint8).reshape(
                3, n).T.tobytes()
            arr = apply_palette(arr, pal)
        return _transpose(arr, orientation)
    return Opened("TIFF", mode, size, load)


def _transpose(arr: np.ndarray, orientation) -> np.ndarray:
    """ImageOps.exif_transpose."""
    if orientation == 2:
        arr = arr[:, ::-1]
    elif orientation == 3:
        arr = arr[::-1, ::-1]
    elif orientation == 4:
        arr = arr[::-1]
    elif orientation == 5:
        arr = arr.swapaxes(0, 1)
    elif orientation == 6:
        arr = np.rot90(arr, -1)
    elif orientation == 7:
        arr = arr[::-1, ::-1].swapaxes(0, 1)
    elif orientation == 8:
        arr = np.rot90(arr, 1)
    return np.ascontiguousarray(arr)


def _mode_array(mode: str, w: int, h: int):
    bands = {"1": 1, "L": 1, "P": 1, "I": 1, "F": 1, "I;16": 1,
             "I;16B": 1, "LA": 2, "PA": 2, "RGB": 3, "LAB": 3,
             "RGBA": 4, "CMYK": 4}[mode]
    dtype = {"1": bool, "I": "<i4", "F": "<f4", "I;16": "<u2",
             "I;16B": ">u2"}.get(mode, np.uint8)
    return np.zeros((h, w, bands) if bands > 1 else (h, w), dtype)


def _unpack_mode(rawmode, buf, w, rows, stride, mode):
    """PIL's unpacker for ``rawmode`` into an image of ``mode``."""
    if rawmode.endswith("R") and rawmode not in ("1;R", "1;IR"):
        # fill order 2: each byte's bits reversed
        b = np.frombuffer(buf, np.uint8)
        buf = np.packbits(np.unpackbits(b).reshape(-1, 8)[:, ::-1]).tobytes()
        rawmode = rawmode[:-1].rstrip(";")
    if rawmode == "I;16N":
        rawmode = "I;16"
    if rawmode[-3:] == "16N":
        rawmode = rawmode[:-1] + "L"
    arr = unpack(rawmode, buf, w, rows, stride)
    if mode == "I;16B":
        arr = arr.astype(">u2")
    return arr


def _raw_tiles(tags, rawmode, w, h, planar, bps, bps_count):
    """_setup's raw tiles, made at open as PIL makes them: (offset, x0,
    y0, x1, y1, raw mode, stride, layer)."""
    if 273 in tags:
        offs = tags[273]
        th = tags.get(278, h)
        tw = w
    else:
        offs = tags[324]
        tw, th = tags.get(322), tags.get(323)
        if not isinstance(tw, int) or not isinstance(th, int):
            raise ValueError("Invalid tile dimensions")
    if tw == w and th == h and planar != 2:
        offs = offs[-1:]
    tiles = []
    x = y = layer = 0
    for off in offs:
        stride = tw * sum(bps) / 8 if x + tw > w else 0
        rm = rawmode
        if planar == 2:
            rm = rawmode[layer]
            stride /= bps_count
        tiles.append((off, x, y, min(x + tw, w), min(y + th, h), rm,
                      int(stride), layer))
        x += tw
        if x >= w:
            x, y = 0, y + th
            if y >= h:
                y = 0
                layer += 1
    return tiles


# the one-letter raw modes PIL unpacks a band of each mode from
_RAW_BANDS = {(m, c): i for m in ("RGB", "RGBA", "CMYK", "LAB")
              for i, c in enumerate(m)}
_RAW_SINGLE = {"L": "L", "P": "P", "1": "1", "F": "F;32F", "I": "I;32N"}


def _load_raw(data, tiles, mode, size, planar, bps):
    """ImageFile.load over PIL's raw tiles: one a strip (or tile), read
    from its offset on; tiles in file order."""
    w, h = size
    out = _mode_array(mode, w, h)
    tiles = sorted(tiles, key=lambda t: t[0])
    # of consecutive tiles that differ in their offset alone, the last
    tiles = [t for k, t in enumerate(tiles)
             if k + 1 == len(tiles) or tiles[k + 1][1:7] != t[1:7]]
    for off, x0, y0, x1, y1, rm, stride, layer in tiles:
        _c_int(off, 63)  # BytesIO.seek's refusals
        if off < 0:
            raise ValueError(f"negative seek value {off}")
        _c_int(stride)  # the raw decoder's arguments
        if planar == 2:
            # PIL's raw decoder with one letter of the raw mode: the
            # unpacker of that band, whatever the samples' size
            if out.ndim == 3:
                band = _RAW_BANDS.get((mode, rm))
                rm = None if band is None else "L"
            else:
                rm = _RAW_SINGLE.get(rm) if rm == mode else None
            if rm is None:
                raise ValueError("unknown raw mode for given image mode")
        for v in (x0, y0, x1, y1):  # the decoder's setimage
            _c_int(v)
        if x0 == 0 and x1 == 0:
            x1, y0, y1 = w, 0, h
        if x0 < 0 or x1 <= x0 or x1 > w or y0 < 0 or y1 <= y0 or y1 > h:
            raise ValueError("tile cannot extend outside image")
        tw_, rows = x1 - x0, y1 - y0
        if planar == 2:
            _check_buffer(tw_, rm)
            rb = row_bytes(rm, tw_)
            st = stride or rb
            arr = unpack(rm, read_rows(data, off, st, rows, rb), tw_, rows, st)
            if out.ndim == 3:
                out[y0:y1, x0:x1, band] = arr
            else:
                out[y0:y1, x0:x1] = arr
            continue
        _check_buffer(tw_, rm)
        rb = row_bytes(_plain(rm), tw_)
        st = stride or rb
        buf = read_rows(data, off, st, rows, rb)
        out[y0:y1, x0:x1] = _unpack_mode(rm, buf, tw_, rows, st, mode)
    return out


def _c_int(v, bits: int = 31) -> None:
    """An argument Python hands to C as an int (``bits`` 63: a
    Py_ssize_t)."""
    if not isinstance(v, int):
        raise TypeError(f"'{type(v).__name__}' object cannot be "
                        "interpreted as an integer")
    if not -2 ** bits <= v < 2 ** bits:
        raise OverflowError(
            "Python int too large to convert to C ssize_t" if bits == 63
            else "signed integer is " + (
                "greater than maximum" if v > 0 else "less than minimum"))


def _check_buffer(width: int, rawmode: str) -> None:
    """The decoder's ``setimage``: a row buffer of more than INT_MAX
    bits is PIL's MemoryError."""
    if width > _INT_MAX // _bits(rawmode) - 7:
        raise MemoryError()


def _plain(rawmode: str) -> str:
    r = rawmode
    if r.endswith("R") and r not in ("1;R", "1;IR"):
        r = r[:-1].rstrip(";")
    return {"I;16N": "I;16"}.get(r, r)


# the CCITT compressions ccitt.cc decodes
_CCITT = (2, 3, 4, 32771)
# the codecs libtiff gives its predictor (TIFFPredictorInit); the others
# ignore the tag
_PREDICTED = (5, 8, 32946, 34925, 50000)
# where each band of a PIL mode sits in its 4-byte pixel: PIL unpacks
# libtiff's separate planes into bytes 0, 1, 2, 3 in turn (its "R", "G",
# "B", "A" band unpackers), so the second plane of LA or PA lands in a
# byte no band shows
_BAND_BYTES = {"LA": (0, 3), "PA": (0, 3), "RGB": (0, 1, 2),
               "LAB": (0, 1, 2), "RGBA": (0, 1, 2, 3), "CMYK": (0, 1, 2, 3)}
_INT_MAX = 0x7FFFFFFF
_BROKEN = "decoder error -2"  # TiffDecode.c's IMAGING_CODEC_BROKEN

_CC_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "ccitt.cc")
_CC_CMD = ("g++", "-O2", "-shared", "-fPIC", "-std=c++17")
_CC_SIGNATURES = {
    "cc_decode": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]),
}


def _load_libtiff(data, ifd, compression, mode, rawmode, size):
    """PIL's libtiff decoder (``TiffDecode.c`` over libtiff 4.7), on the
    directory as libtiff reads it (``libtiff_dir``): the image's size
    must be PIL's; the strips or tiles are read in its order (row of
    blocks, plane, column) into one buffer it keeps from block to block,
    each decompressed, its predictor undone and unpacked into the image
    with the native-order raw mode, or, for separate planes, plane by
    plane into the bytes of PIL's pixel."""
    if rawmode == "RGB" and mode != "RGB":
        # _setup's raw mode for YCbCr JPEG, which PIL's decoder refuses
        # for a one-band mode before libtiff runs
        raise ValueError("unknown raw mode for given image mode")
    _check_buffer(size[0], rawmode)
    first, e, big = ifd
    try:
        d = libtiff_dir.read_directory(data, first, e, big)
    except libtiff_dir.Refused as err:
        raise OSError(_BROKEN) from err
    w, h = size
    if (d.width, d.length) != (w, h):
        raise OSError(_BROKEN)  # TiffDecode.c's "Inconsistent Image Error"
    if d.compression == 6:
        raise item16("TIFF old-style JPEG (compression 6)")
    # JPEG YCbCr in one plane comes out as RGB (JPEGCOLORMODE_RGB); any
    # other YCbCr goes through libtiff's RGBA reader
    upsampled = d.photometric == 6 and d.compression == 7 and d.planar == 1
    if d.photometric == 6 and not upsampled:
        return _load_ycbcr(data, d, size, e)
    bands = len(_BAND_BYTES.get(mode, (0,)))
    planes = 1
    if d.planar == 2 and bands > 1:
        if d.bps not in (8, 16):
            raise OSError(_BROKEN)  # no band unpackers of other sizes
        planes = bands
    if d.tiled:
        bw, bh = d.tilewidth, d.tilelength
        if bw > _INT_MAX or bh > _INT_MAX:
            raise OSError("decoder error -9")
        block = libtiff_dir.tile_size(d, upsampled)
        rowb = libtiff_dir.tile_row_size(d)
        if not block or not rowb or rowb > block:
            raise OSError(_BROKEN)
        if block > _INT_MAX - 1:
            raise OSError("decoder error -9")
        # libtiff's tile may not hold more than PIL's unpacker reads
        if block > (bw * _bits(rawmode) // planes + 7) // 8 * bh:
            raise OSError(_BROKEN)
    else:
        bw = w
        bh = d.rowsperstrip if d.rowsperstrip_set and \
            d.rowsperstrip != 0xFFFFFFFF else h
        rowb = libtiff_dir.scanline_size(d, upsampled)
        block = libtiff_dir.strip_size(d, min(d.rowsperstrip, d.length),
                                       upsampled)  # TIFFStripSize
        # libtiff's scanline may not be shorter than PIL's unpacker's row,
        # nor its strip longer than PIL's rows of them
        unpacked = (w * _bits(rawmode) // planes + 7) // 8
        if not rowb or rowb < unpacked or block > unpacked * bh:
            raise OSError(_BROKEN)
    out = _mode_array(mode, w, h)
    buf = np.zeros(block, np.uint8)  # PIL's buffer, kept block to block
    noeol = ctypes.c_int(0)  # libtiff's Group 3 codec state, per image
    y0 = 0
    while y0 < h:
        for plane in range(planes):
            for x0 in range(0, w, bw):
                try:
                    if d.tiled:
                        index, rows, need = _tile(d, x0, y0, plane), bh, block
                    else:
                        index = _strip(d, y0 & 0xFFFFFFFF, plane)
                        rows = libtiff_dir.strip_rows(d, index)
                        need = min(block, libtiff_dir.strip_size(
                            d, rows, upsampled))
                    _decode_block(data, d, index, (bw, rows, rowb), e,
                                  buf[:need], noeol,
                                  not d.tiled and y0 + rows >= h, upsampled)
                except JPEGUnsupported as err:
                    raise item16("TIFF JPEG variant") from err
                except Exception as err:  # noqa: BLE001 -- libtiff's failure
                    raise OSError(_BROKEN) from err
                # PIL's rows of the block (its row count an INT32)
                ys = min(_int32(bh), h - y0)
                if ys <= 0:
                    continue
                xs = min(bw, w - x0)
                body = buf[:ys * rowb].tobytes()
                if planes == 1:
                    arr = _unpack_mode(rawmode, body, bw, ys, rowb, mode)
                    out[y0:y0 + ys, x0:x0 + xs] = arr[:ys, :xs]
                elif plane in _BAND_BYTES[mode]:
                    band = np.frombuffer(body, np.uint8).reshape(ys, rowb)
                    if d.bps == 16:
                        band = band[:, 1::2]  # the high byte ("R;16N")
                    out[y0:y0 + ys, x0:x0 + xs,
                        _BAND_BYTES[mode].index(plane)] = band[:, :xs]
        y0 = _int32(y0 + bh)  # PIL's INT32 row wraps past 2**31
    if planes > 3 and mode == "RGBA" and d.extrasamples[:1] in ((0,), (1,)):
        out = unpremultiply(out)
    return out


def _int32(v: int) -> int:
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _strip(d, y: int, plane: int) -> int:
    """TIFFComputeStrip (a plane past the samples reads strip 0);
    _Unfilled where TIFFReadEncodedStrip refuses the strip."""
    strip = y // d.rowsperstrip
    if d.planar == 2:
        strip = strip + plane * d.stripsperimage if plane < d.spp else 0
    if strip >= d.nstrips:
        raise _Unfilled("strip out of range")
    return strip


def _tile(d, x: int, y: int, plane: int) -> int:
    """TIFFCheckTile and TIFFComputeTile (z = 0)."""
    if x >= d.width or y >= d.length or d.depth == 0 or (
            d.planar == 2 and plane >= d.spp):
        raise _Unfilled("tile out of range")
    across = -(-d.width // d.tilewidth)
    tile = across * (y // d.tilelength) + x // d.tilewidth
    if d.planar == 2:
        tile += across * -(-d.length // d.tilelength) * -(
            -d.depth // d.tiledepth) * plane
    if tile >= d.nstrips:
        raise _Unfilled("tile out of range")
    return tile


def _load_ycbcr(data, d, size, e):
    """PIL's _decodeAsRGBA: YCbCr read through libtiff's TIFFRGBAImage,
    one strip or row of tiles at a time. Its subsampled blocks (contiguous
    planes, 1, 2 or 4 across by 1, 2 or 4 down) or separate planes (no
    subsampling) are converted by libtiff's fixed-point tables (PIL asks
    for them top-left, as stored). This reader does not stop at errors: a
    strip or tile that fails reads as zeros, and only a failure before
    the reader's buffer exists (its first block of a row: a strip or tile
    out of range, of no bytes, or past the file's end) fails the image."""
    w, h = size
    planar = d.planar
    try:
        hs, vs = d.subsampling
        if d.bps != 8 or d.spp != 3 or d.sampleformat == 3 or not vs or (
                (hs, vs) != (1, 1) if planar == 2 else
                (hs, vs) not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1),
                                 (4, 2), (4, 4))):
            raise ValueError("Can not handle format")
        if d.compression not in _CODECS:
            raise ValueError("compression method is not configured")
        tables = _ycbcr_tables(d.coefficients, d.refbw)
    except (TypeError, IndexError, KeyError, ValueError) as err:
        raise OSError(_BROKEN) from err
    tiled = d.tiled
    bw = d.tilewidth if tiled else w
    bh = d.tilelength if tiled else (
        d.rowsperstrip if d.rowsperstrip != 0xFFFFFFFF else h)
    if _INT_MAX // 4 < w or _INT_MAX // (w * 4) < bh:
        raise OSError("decoder error -9")  # PIL's RGBA block buffer
    n = hs * vs + 2
    row_blocks = -(-bw // hs)
    out = np.zeros((h, w, 3), np.uint8)
    for y0 in range(0, h, bh):
        rows = min(bh, h - y0)
        coded = bh if tiled else rows
        size = bw * coded if planar == 2 else -(-coded // vs) * row_blocks * n
        # libtiff reads a strip only as far as its rows, rounded up to the
        # subsampling, times a scanline of a block row's bytes over vs
        limit = size if tiled or planar == 2 else min(
            size, -(-coded // vs) * vs * (row_blocks * n // vs))
        got = None  # libtiff's buffer: zeroed at the block row's first read
        for x0 in range(0, w, bw):
            for plane in range(3 if planar == 2 else 1):
                first = got is None
                if first:
                    got = [np.zeros(size, np.uint8)
                           for _ in range(3 if planar == 2 else 1)]
                try:
                    if tiled:
                        index, brows = _tile(d, x0, y0, plane), bh
                    else:
                        index = _strip(d, y0, plane)
                        brows = libtiff_dir.strip_rows(d, index)
                    need = min(limit, libtiff_dir.tile_size(d) if tiled
                               else libtiff_dir.strip_size(d, brows))
                    _decode_block(data, d, index, (bw, coded, 0), e,
                                  got[plane][:need], None,
                                  not tiled and y0 + rows >= h, False)
                except JPEGUnsupported as err:
                    raise item16("TIFF JPEG variant") from err
                except _Unfilled as err:
                    if first:  # no buffer yet: TIFFRGBAImageGet fails
                        raise OSError(_BROKEN) from err
                    got[plane][:] = 0
                except Exception:  # noqa: BLE001 -- libtiff reads on
                    got[plane][:] = 0
            cols = min(bw, w - x0)
            if planar == 2:
                ycc = [p.reshape(coded, bw) for p in got]
            else:
                # libtiff skips the blocks of a tile past the image's edge
                # by (skip / hs) blocks of hs * 2 + 2 bytes, which is a
                # block only for 4 x 2 and smaller
                skip = (bw - cols) // hs * (hs * 2 + 2 if vs == 4 else n)
                ycc = _ycbcr_samples(got[0], coded, cols, hs, vs,
                                     -(-cols // hs) * n + skip)
            rgb = _ycbcr_to_rgb(tables, *ycc)[:rows, :cols]
            out[y0:y0 + rows, x0:x0 + cols] = rgb
    return out


def _ycbcr_tables(luma, refbw):
    """TIFFYCbCrToRGBInit in libtiff's float32 and 16-bit fixed point."""
    f32 = np.float32
    luma = np.array(luma if luma is not None else (0.299, 0.587, 0.114),
                    f32)
    ref = np.array(refbw if refbw is not None else
                   (0, 255, 128, 255, 128, 255), f32)
    if len(luma) < 3 or len(ref) < 6 or np.isnan(luma).any() or \
            luma[1] == 0 or not ((ref > -0x7FFFFFFF + 128) &
                                 (ref < 0x7FFFFFFF - 128)).all():
        raise ValueError("Invalid YCbCrCoefficients or ReferenceBlackWhite")

    def fix(x):
        return int(float(x) * 65536 + 0.5)

    with np.errstate(all="ignore"):
        f1 = f32(2) - f32(2) * luma[0]
        f2 = luma[0] * f1 / luma[1]
        f3 = f32(2) - f32(2) * luma[2]
        f4 = luma[2] * f3 / luma[1]
        d1, d2 = fix(np.clip(f1, 0, 2)), -fix(np.clip(f2, 0, 2))
        d3, d4 = fix(np.clip(f3, 0, 2)), -fix(np.clip(f4, 0, 2))

        def code2v(c, rb, rw, cr):
            span = rw - rb
            return (f32(c - np.int64(np.trunc(rb))) * f32(cr)) / (
                span if span != 0 else f32(1))

        x = np.arange(-128, 128)
        cr = np.trunc(np.clip(code2v(x, ref[4] - f32(128), ref[5] - f32(128),
                                     127), -4096, 4096)).astype(np.int64)
        cb = np.trunc(np.clip(code2v(x, ref[2] - f32(128), ref[3] - f32(128),
                                     127), -4096, 4096)).astype(np.int64)
        y = np.trunc(np.clip(code2v(x + 128, ref[0], ref[1], 255), -4096,
                             4096)).astype(np.int64)
    return ((d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr,
            d4 * cb + 32768, y)


def _ycbcr_samples(buf, rows, cols, hs, vs, stride):
    """Y, Cb and Cr of each pixel from blocks of hs x vs luma samples and
    one Cb and Cr, ceil(cols / hs) blocks to a row of blocks, rows of
    blocks ``stride`` bytes apart."""
    bx, by, n = -(-cols // hs), -(-rows // vs), hs * vs + 2
    need = (by - 1) * stride + bx * n
    buf = np.concatenate([buf, np.zeros(max(0, need - len(buf)), np.uint8)])
    blk = np.lib.stride_tricks.as_strided(
        buf, (by, bx, n), (stride, n, 1)).copy()
    y = blk[:, :, :-2].reshape(by, bx, vs, hs).transpose(0, 2, 1, 3)
    y = y.reshape(by * vs, bx * hs)

    def up(c):
        return np.repeat(np.repeat(c, vs, 0), hs, 1)
    return y, up(blk[:, :, -2]), up(blk[:, :, -1])


def _ycbcr_to_rgb(tables, y, cb, cr):
    """TIFFYCbCrtoRGB over arrays of samples."""
    cr_r, cb_b, cr_g, cb_g, y_tab = tables
    yy = y_tab[y]
    rgb = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16),
                    yy + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _bits(rawmode: str) -> int:
    """Bits a pixel of PIL's unpacker for ``rawmode`` takes."""
    r = _plain(rawmode)
    return row_bytes(r[:-1] + "L" if r.endswith("16N") else r, 8)


class _Unfilled(ValueError):
    """libtiff's TIFFReadEncodedStrip / Tile failed before it decoded:
    the strip or tile is out of range, has no bytes or lies past the
    file's end."""


# libtiff's compression -> the port's codec (PIL's names)
_CODECS = {k: v for k, v in _COMPRESSION.items()
           if v not in ("tiff_jpeg", "webp", "tiff_sgilog", "tiff_sgilog24")}


def _decode_block(data, d, index, shape, e, out, noeol, last, upsampled):
    """libtiff's TIFFReadEncodedStrip / Tile of block ``index`` into
    ``out`` (a uint8 array of as many bytes as libtiff reads; ``shape``
    is the block's width, rows and scanline bytes); raises where it
    fails."""
    bw, rows, rowb = shape
    off, cnt = d.offsets[index], d.counts[index]
    if not cnt:
        raise _Unfilled("Invalid strip byte count 0")
    if cnt > 1 << 20:  # TIFFFillStrip's cap on a large byte count
        full = libtiff_dir.tile_size(d, upsampled) if d.tiled else \
            libtiff_dir.strip_size(d, min(d.rowsperstrip, d.length),
                                   upsampled)
        if full and (cnt - 4096) // 10 > full:
            cnt = full * 10 + 4096
    if cnt > len(data) or off > len(data) - cnt:
        raise _Unfilled("Read error on strip")
    raw = data[off:off + cnt]
    # TIFFStartStrip: the codec's setup (once it succeeds) and its per-strip
    # start; a failure there is TIFFFillStrip's
    codec = _CODECS.get(d.compression)
    if codec is None:
        # PIL 12.1's libtiff is built without WebP ("WEBP compression
        # support is not configured"), and its SGILog codec takes the
        # LogLuv and LogL photometrics only, which PIL's mode table lacks
        raise _Unfilled(f"no decoder for compression {d.compression}")
    if d.compression in _CCITT and d.bps != 1:
        raise _Unfilled("Bits/sample must be 1 for Group 3/4")
    if codec == "tiff_thunderscan" and d.bps != 4:
        raise _Unfilled("ThunderScan takes 4-bit samples")
    predictor = d.predictor if d.compression in _PREDICTED else 1
    if predictor not in (1, 2, 3) or (predictor == 2 and d.bps not in (
            8, 16, 32, 64)) or (predictor == 3 and (d.sampleformat != 3 or (
                d.bps not in (16, 24, 32, 64)))):
        raise _Unfilled(f"Predictor {predictor} not supported")
    spp = 1 if d.planar == 2 else d.spp
    need = len(out)
    if d.compression in _CCITT:
        opts = d.g3opts if d.compression == 3 else \
            d.g4opts if d.compression == 4 else 0
        if _cc_lib().cc_decode(
                raw, len(raw), d.compression, opts,
                int(d.fillorder != 2), bw, rowb, rows, off,
                out.ctypes.data, ctypes.byref(noeol)) < 0:
            raise ValueError("CCITT data broken")
        return
    if d.fillorder == 2:
        # FillOrder 2: libtiff reverses the bits of the raw bytes first
        raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
    if codec == "jpeg":
        # JPEGDecode: the frame's rows (no more than the block's), each
        # at the start of the block's scanline; the rest stays as it was
        px = _jpeg_strip(raw, d.jpegtables, d.photometric, bw, rows, last,
                         spp, d.bps)
        stride = rowb or bw * spp
        n = min(len(px), need // stride)
        flat = px[:n].reshape(n, -1)
        out[:n * stride].reshape(n, stride)[:, :flat.shape[1]] = flat
        return
    if codec == "tiff_thunderscan":
        px = _thunder(raw, bw, rows, rowb, out)
    elif codec == "raw":
        px = raw  # DumpModeDecode
    else:
        px = _decompress(codec, raw, need)
    if len(px) < need:
        raise ValueError("short strip")
    if predictor != 1 and need != rows * ((bw * d.bps * spp + 7) // 8):
        raise ValueError("a predictor on subsampled YCbCr")
    out[:] = np.frombuffer(_predict(px[:need], predictor, d.bps, spp, bw,
                                    rows, e), np.uint8)


_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)


def _cc_lib():
    return _build.load(_CC_CMD, _CC_SRC, _CC_SIGNATURES)


def _decompress(compression, raw, need):
    if compression == "tiff_lzw":
        return lzw_decode_native(raw, max_size=need)
    if compression == "packbits":
        return _packbits_decode(raw)
    if compression == "zstd":
        # libtiff streams the frame until the strip is full
        return zstd.decompress_stream(raw, need)
    if compression == "lzma":
        return _xz(raw, need)
    if compression in ("tiff_adobe_deflate", "tiff_deflate"):
        return zlib.decompressobj().decompress(raw, need)
    raise ValueError(f"no {compression} decoder")


def _xz(raw: bytes, need: int) -> bytes:
    """libtiff's LZMADecode: liblzma decodes the strip's .xz stream into a
    ``need``-byte buffer in one run, and what it wrote before an error
    counts: the strip is whole if the buffer filled. The stdlib drops a
    call's output at an error, so a stream that fails is decoded again:
    its headers alone (their checks come before any byte), then the
    block's LZMA2 data without the checks that liblzma makes only after
    the buffer is full (the chunk's range coder and sizes, the block's
    check, the index)."""
    import lzma  # the .xz stream libtiff writes per strip or tile
    try:
        return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(
            raw, max_length=need)
    except lzma.LZMAError:
        pass
    try:
        lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(
            raw[:12 + (raw[12] + 1) * 4])
        filters, chunks = _xz_block(raw, need)
        return lzma.LZMADecompressor(lzma.FORMAT_RAW, filters=filters
                                     ).decompress(chunks, max_length=need)
    except (lzma.LZMAError, ValueError, IndexError):
        return b""


def _xz_block(raw: bytes, need: int):
    """The filter chain of the first block of an .xz stream, and its LZMA2
    data with the chunk that reaches byte ``need`` made to reach past it
    (its unpacked size a byte larger if it ends there, and an LZMA chunk's
    packed size the most there is: liblzma's LZMA decoder reads on past
    its chunk, and the chunk's size is checked only after it returns)."""
    import lzma
    p = 12 + (raw[12] + 1) * 4  # past the stream and block headers
    flags = raw[13]
    q = 14
    for present in (flags & 0x40, flags & 0x80):  # the sizes, if present
        if present:
            q += _vli_len(raw, q)
    filters = []
    for _ in range((flags & 3) + 1):
        fid = _vli(raw, q)
        q += _vli_len(raw, q)
        plen = _vli(raw, q)
        q += _vli_len(raw, q)
        props = raw[q:q + plen]
        q += plen
        if fid == lzma.FILTER_LZMA2:
            d = props[0]
            filters.append({"id": fid, "dict_size": 0xFFFFFFFF if d == 40
                            else (2 | (d & 1)) << (d // 2 + 11)})
        elif fid == lzma.FILTER_DELTA:
            filters.append({"id": fid, "dist": props[0] + 1})
        else:
            raise ValueError("a filter libtiff does not write")
    data = bytearray(raw[p:])
    pos = made = 0
    while True:
        c = data[pos]
        if c >= 0x80:
            size = ((c & 0x1F) << 16 | data[pos + 1] << 8 | data[pos + 2]) + 1
            head = 6 if c >= 0xC0 else 5
            packed = (data[pos + 3] << 8 | data[pos + 4]) + 1
        elif c in (1, 2):
            size = (data[pos + 1] << 8 | data[pos + 2]) + 1
            head, packed = 3, size
        else:
            raise ValueError("the LZMA2 data ends before the strip")
        if made + size < need:
            made += size
            pos += head + packed
            continue
        size += made + size == need
        if c >= 0x80:
            if size > 1 << 21:
                raise ValueError("a full chunk")
            data[pos] = c & 0xE0 | (size - 1) >> 16
            data[pos + 1:pos + 5] = ((size - 1) & 0xFFFF).to_bytes(
                2, "big") + b"\xff\xff"
        else:
            if size > 1 << 16:
                raise ValueError("a full chunk")
            data[pos + 1:pos + 3] = (size - 1).to_bytes(2, "big")
        return filters, bytes(data)


def _vli(buf: bytes, pos: int) -> int:
    n = shift = 0
    while True:
        b = buf[pos]
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n
        pos += 1
        shift += 7


def _vli_len(buf: bytes, pos: int) -> int:
    k = 1
    while buf[pos + k - 1] & 0x80:
        k += 1
    return k


_TWO_BIT = (0, 1, 0, -1)
_THREE_BIT = (0, 1, 2, 3, 0, -3, -2, -1)


def _thunder(raw: bytes, width: int, rows: int, rowb: int, buf) -> bytes:
    """libtiff's ThunderDecode, row by row: 4-bit pixels from runs of the
    last one, 2-bit or 3-bit deltas, or raw values. A run that would run
    past the row's end writes nothing (one that ends at it does)."""
    out = bytearray(buf[:rows * rowb].tobytes())
    pos = 0
    for r in range(rows):
        op = r * rowb
        last = npix = 0

        def put(v):
            nonlocal last, npix, op
            last = v & 0xF
            if npix < width:
                if npix & 1:
                    out[op] |= last
                    op += 1
                else:
                    out[op] = last << 4
                npix += 1
        while pos < len(raw) and npix < width:
            n = raw[pos]
            pos += 1
            code = n & 0xC0
            if code == 0x00:
                if npix & 1:
                    out[op] |= last
                    last = out[op]
                    op += 1
                    npix += 1
                    n -= 1
                else:
                    last |= last << 4
                npix += n
                if npix <= width:
                    while n > 0:
                        out[op] = last
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    out[op] &= 0xF0
                last &= 0xF
            elif code == 0x40:
                for d in ((n >> 4) & 3, (n >> 2) & 3, n & 3):
                    if d != 2:
                        put(last + _TWO_BIT[d])
            elif code == 0x80:
                for d in ((n >> 3) & 7, n & 7):
                    if d != 4:
                        put(last + _THREE_BIT[d])
            else:
                put(n)
        if npix != width:
            raise ValueError("ThunderScan row of the wrong length")
    return bytes(out)


def _predict(buf: bytes, predictor: int, bps: int, spp: int, w: int,
             rows: int, e: str) -> bytes:
    """libtiff's predictors, leaving native-order samples."""
    k = bps // 8
    if predictor == 1:
        if bps in (16, 32) and e == ">":
            return np.frombuffer(buf, ">u%d" % k).astype("<u%d" % k).tobytes()
        return buf
    if predictor == 2 and bps in (8, 16, 32):
        a = np.frombuffer(buf, e + "u%d" % k).reshape(rows, w, spp)
        return _undo_hpredictor(a).astype("<u%d" % k).tobytes()
    if predictor == 3 and bps in (32, 64):
        return _undo_fpredictor(buf, rows, w, spp,
                                np.dtype("<f%d" % k)).tobytes()
    raise ValueError(f"predictor {predictor}")


# libtiff's JPEG source supplies a fake EOI each time the strip or the
# tables run out (std_fill_input_buffer): as much of it as a marker segment
# cut short can take
_FAKE_EOI = b"\xff\xd9" * 32770


def _jpeg_tables(tables: bytes) -> bytes:
    """The marker segments libjpeg reads from JPEGTables, as libtiff feeds
    them (JPEGSetupDecode): from the SOI to the EOI it reaches, the fake
    EOIs past the tables' end included."""
    s = tables + _FAKE_EOI
    if s[:2] != b"\xff\xd8":
        raise _Unfilled("Bogus JPEGTables field")
    p = 2
    while p < len(s):
        while p < len(s) and s[p] != 0xFF:  # next_marker
            p += 1
        q = p
        while q < len(s) and s[q] == 0xFF:
            q += 1
        if q + 2 >= len(s):
            break
        code = s[q]
        if code == 0xD9:
            return s[2:p]
        if code == 0 or code == 1 or 0xD0 <= code <= 0xD8:
            p = q + 1
        else:
            p = q + 1 + (s[q + 1] << 8 | s[q + 2])
    return tables


def _jpeg_strip(raw: bytes, tables, photometric, width: int, rows: int,
                last: bool, spp: int, bits: int) -> np.ndarray:
    """One JPEG strip or tile: the file's tables, then the strip's
    frame, decoded by the port's libjpeg-turbo-equal decoder. libtiff
    asks libjpeg for RGB from a YCbCr file (a JFIF marker makes the
    decoder take the components as YCbCr) and for the components as they
    are otherwise (an Adobe marker with transform 0). Tables or a strip
    that does not start with an SOI, and a header libtiff's JPEGPreDecode
    refuses, are a failure of TIFFFillStrip (_Unfilled)."""
    segments = _jpeg_tables(tables) if tables else b""  # JPEGSetupDecode
    if (raw + _FAKE_EOI)[:2] != b"\xff\xd8":
        raise _Unfilled("Not a JPEG file")  # libjpeg's first_marker
    head = b"\xff\xd8"
    if photometric == 6:
        head += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    else:
        head += b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    stream = head + segments + raw[2:] + _FAKE_EOI
    try:
        # libtiff's JPEGPreDecode checks (the decoder takes 8-bit
        # samples only)
        jh, jw, sampling = jpeg_frame(stream)
        if jw == width and jh > rows and last:
            pass  # a last strip coded at full height: libtiff cuts it
        elif jw > width or jh > rows:  # a smaller frame is its warning
            raise ValueError("JPEG strip/tile size exceeds the TIFF's")
        if len(sampling) != spp or bits != 8:
            raise ValueError("improper JPEG component count or precision")
        if photometric != 6 and any(s != (1, 1) for s in sampling):
            # libtiff reads such a file raw, downsampled (a sampling that
            # differs from the YCbCr tag is only its warning)
            raise ValueError("downsampled JPEG without YCbCr")
    except JPEGUnsupported:
        raise
    except Exception as err:  # noqa: BLE001 -- JPEGPreDecode's failure
        raise _Unfilled(str(err)) from err
    return np.ascontiguousarray(decode_jpeg_array(stream)[:rows])
