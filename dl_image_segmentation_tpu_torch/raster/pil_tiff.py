"""TIFF as PIL 12.1 reads it (``TiffImagePlugin``), on the port's own
codecs: the first page, in PIL's modes.

The header and the first IFD are read as ``ImageFileDirectory_v2``
reads them, through ``geotiff.py``'s entry reader (a tag of an unknown
type is skipped, a tag whose data lies past the end stops the directory
there), then ``_setup`` picks the mode
from PIL's ``OPEN_INFO`` table: (byte order, photometric, sample
format, fill order, bits per sample, extra samples) -> (mode, raw
mode). What the table lacks is PIL's ``SyntaxError`` "unknown pixel
mode", which sends the bytes on to the next opener. So 1-bit images
decode to bool, MinIsWhite is inverted, palette images expand to RGB,
16-bit grey keeps its byte order (``<u2``, or ``>u2`` for a big-endian
file), signed 16-bit and 32-bit grey are int32, float is float32, LA
has 2 bands and CMYK 4; 16-bit RGB is PIL's 8-bit RGB (the high
bytes).

Uncompressed files are read as PIL's raw decoder reads them, strip by
strip (``OSError`` "image file is truncated" when the data ends
first; separate planes through the one-letter band unpackers PIL picks).
Compressed ones go through libtiff 4.7 in PIL, as its ``TiffDecode.c``
reads them: strips or tiles in its order into one buffer it keeps,
LZW, Deflate and PackBits (``geotiff.py``'s), zstd (``storage/zstd.py``,
the port's own decoder), LZMA (the stdlib's ``lzma``: libtiff writes an
.xz stream a strip), ThunderScan, CCITT Modified Huffman, Group 3 and
Group 4 (``csrc/host/ccitt.cc``, libtiff's ``tif_fax3.c`` step for step),
and JPEG (compression 7) through the port's ``jpeg.cc``, each strip or
tile with the file's ``JPEGTables``, converted from YCbCr to RGB by the
JPEG decoder as PIL asks libtiff to (``JPEGCOLORMODE_RGB``). Predictors
are undone for the codecs libtiff gives them to; FillOrder 2 reverses
the raw bits; 12-bit grey unpacks to PIL's I;16. Separate planes go
plane by plane into the bytes of PIL's pixel (an RGBa image is
unpremultiplied after). YCbCr in any other form goes through libtiff's
RGBA reader (subsampled blocks, its fixed-point conversion). Where
libtiff fails, PIL's ``OSError`` "decoder error -2"; so for WebP (PIL
12.1's libtiff is built without it) and SGILog (no mode of PIL's).
Old-style JPEG (compression 6) raises :class:`UnsupportedFormat` naming
ROADMAP queue 1 item 16. The EXIF orientation is applied as
``ImageOps.exif_transpose`` does.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from .. import _build
from ..storage import zstd
from .geotiff import (_ifd_entries, _ifd_value_bytes, _packbits_decode,
                      _undo_fpredictor, _undo_hpredictor)
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
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("L", 4), 5: ("LL", 8),
          6: ("b", 1), 7: ("s", 1), 8: ("h", 2), 9: ("l", 4), 10: ("ll", 8),
          11: ("f", 4), 12: ("d", 8), 13: ("L", 4), 16: ("Q", 8)}
# tags TiffTags declares with one value
_SINGLE = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323}
_MAX_SAMPLES = 256


def _load_ifd(data: bytes, offset: int, e: str, big: bool) -> dict:
    """ImageFileDirectory_v2.load: {tag: value}. A short read of the
    entries or of a tag's data stops the directory (PIL warns and keeps
    what it read), and marks it cut short."""
    tags = {}
    try:
        for tag, typ, n, field in _ifd_entries(data, e, big, offset):
            if len(field) < (8 if big else 4):
                raise struct.error("IFD entry cut short")
            if typ not in _TYPES:
                continue
            code, unit = _TYPES[typ]
            body = _ifd_value_bytes(data, e, n * unit, field, big)
            if len(body) < n * unit:
                raise struct.error("IFD values cut short")
            if not body:
                continue
            if typ in (2, 7):
                vals = (body,)
            elif typ in (5, 10):
                pairs = struct.unpack(e + code[0] * (2 * n), body)
                vals = tuple(pairs[2 * i] / pairs[2 * i + 1]
                             if pairs[2 * i + 1] else float("nan")
                             for i in range(n))
            else:
                vals = struct.unpack(e + code * n, body)
            if tag in _SINGLE or typ == 1 or (tag not in _MULTI
                                              and len(vals) == 1):
                vals = vals[0]
            tags[tag] = vals
    except struct.error:
        # libtiff, which decodes compressed files, reads the whole
        # directory again and fails where PIL's reader stopped
        tags[_PARTIAL] = True
    return tags


_PARTIAL = -1


# tags TiffTags declares with a variable count (kept as tuples)
_MULTI = {258, 273, 279, 320, 324, 325, 338, 339, 347}


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
    return _setup(data, tags, order, e)


def _setup(data: bytes, tags: dict, order: bytes, e: str) -> Opened:
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
    # a BYTE-typed tag holds one number, not a tuple: PIL's len() and
    # slicing of it raise TypeError, which sends the bytes on
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
        raw_tiles = _raw_tiles(tags, rawmode, xsize, ysize, planar, bps)
    palette = None
    if mode in ("P", "PA"):
        cmap = tags[320]
        palette = bytes(b // 256 for b in cmap)  # "RGB;L": three planes
    w, h = xsize, ysize

    def load():
        check_bomb((w, h))
        if libtiff:
            arr = _load_libtiff(data, tags, compression, mode, rawmode,
                                (w, h), planar, bps, e)
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


def _raw_tiles(tags, rawmode, w, h, planar, bps):
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
            stride /= len(bps)
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
    tiles = list(tiles)
    tiles.sort(key=lambda t: t[0])
    for off, x0, y0, x1, y1, rm, stride, layer in tiles:
        tw_, rows = x1 - x0, y1 - y0
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
            rb = row_bytes(rm, tw_)
            st = stride or rb
            arr = unpack(rm, read_rows(data, off, st, rows, rb), tw_, rows, st)
            if out.ndim == 3:
                out[y0:y1, x0:x1, band] = arr
            else:
                out[y0:y1, x0:x1] = arr
            continue
        rb = row_bytes(_plain(rm), tw_)
        st = stride or rb
        buf = read_rows(data, off, st, rows, rb)
        out[y0:y1, x0:x1] = _unpack_mode(rm, buf, tw_, rows, st, mode)
    return out


def _plain(rawmode: str) -> str:
    r = rawmode
    if r.endswith("R") and r not in ("1;R", "1;IR"):
        r = r[:-1].rstrip(";")
    return {"I;16N": "I;16"}.get(r, r)


# TIFF compression -> the scheme ccitt.cc decodes
_CCITT = {"tiff_ccitt": 2, "tiff_raw_16": 32771, "group3": 3, "group4": 4}
# the codecs libtiff gives its predictor (TIFFPredictorInit); the others
# ignore the tag
_PREDICTED = ("tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "lzma",
              "zstd")
# where each band of a PIL mode sits in its 4-byte pixel: PIL unpacks
# libtiff's separate planes into bytes 0, 1, 2, 3 in turn (its "R", "G",
# "B", "A" band unpackers), so the second plane of LA or PA lands in a
# byte no band shows
_BAND_BYTES = {"LA": (0, 3), "PA": (0, 3), "RGB": (0, 1, 2),
               "LAB": (0, 1, 2), "RGBA": (0, 1, 2, 3), "CMYK": (0, 1, 2, 3)}

_CC_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "ccitt.cc")
_CC_CMD = ("g++", "-O2", "-shared", "-fPIC", "-std=c++17")
_CC_SIGNATURES = {
    "cc_decode": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]),
}


def _load_libtiff(data, tags, compression, mode, rawmode, size, planar, bps,
                  e):
    """PIL's libtiff decoder (``TiffDecode.c`` over libtiff 4.7): the
    strips or tiles read in its order (row of blocks, plane, column) into
    one buffer it keeps from block to block, each decompressed, its
    predictor undone and unpacked into the image with the native-order
    raw mode, or, for separate planes, plane by plane into the bytes of
    PIL's pixel."""
    if compression == "tiff_jpeg":
        raise item16("TIFF old-style JPEG (compression 6)")
    if rawmode == "RGB" and mode != "RGB":
        # _setup's raw mode for YCbCr JPEG, which PIL's decoder refuses
        # for a one-band mode before libtiff runs
        raise ValueError("unknown raw mode for given image mode")
    if tags.get(262, 0) == 6 and not (compression == "jpeg" and planar == 1):
        return _load_ycbcr(data, tags, compression, size, planar, bps, e)
    w, h = size
    bands = len(_BAND_BYTES.get(mode, (0,)))
    planes = bands if planar == 2 and bands > 1 else 1
    try:
        if _PARTIAL in tags:
            raise ValueError("directory cut short")
        if compression in ("webp", "tiff_sgilog", "tiff_sgilog24"):
            # PIL 12.1's libtiff is built without WebP ("WEBP compression
            # support is not configured"), and its SGILog codec takes the
            # LogLuv and LogL photometrics only, which PIL's mode table
            # lacks
            raise ValueError(f"no {compression} decoder in PIL's libtiff")
        if planes > 1 and bps[0] not in (8, 16):
            raise ValueError("separate planes of neither 8 nor 16 bits")
        tiled, bw, bh, offs, cnts = _blocks(tags, w, h)
        # the scanline libtiff decodes (one sample wide for separate
        # planes); PIL checks a strip's against what its unpacker reads
        rowb = (bw * bps[0] * (1 if planar == 2 else len(bps)) + 7) // 8
        if not tiled and rowb < (bw * _bits(rawmode) // planes + 7) // 8:
            raise ValueError("scanline shorter than the unpacker's")
    except (TypeError, IndexError, KeyError, ValueError) as err:
        raise OSError("decoder error -2") from err
    out = _mode_array(mode, w, h)
    across = -(-w // bw) if tiled else 1
    down = -(-h // bh)
    buf = np.zeros(bh * rowb, np.uint8)  # PIL's buffer, kept from block
    # to block
    noeol = ctypes.c_int(0)  # libtiff's Group 3 codec state, per image
    for by in range(down):
        y0 = by * bh
        rows = bh if tiled else min(bh, h - y0)
        for plane in range(planes):
            for bx in range(across):
                x0 = bx * bw
                index = by * across + bx + (
                    plane * across * down if planar == 2 else 0)
                try:
                    _decode_block(data, tags, compression, offs, cnts, index,
                                  (bw, rows, rowb), bps, planar, e,
                                  buf[:rows * rowb], noeol,
                                  not tiled and y0 + rows >= h)
                except JPEGUnsupported as err:
                    raise item16("TIFF JPEG variant") from err
                except Exception as err:  # noqa: BLE001 -- libtiff's failure
                    raise OSError("decoder error -2") from err
                ys, xs = min(rows, h - y0), min(bw, w - x0)
                body = buf[:rows * rowb].tobytes()
                if planes == 1:
                    arr = _unpack_mode(rawmode, body, bw, rows, rowb, mode)
                    out[y0:y0 + ys, x0:x0 + xs] = arr[:ys, :xs]
                elif plane in _BAND_BYTES[mode]:
                    band = np.frombuffer(body, np.uint8).reshape(rows, rowb)
                    if bps[0] == 16:
                        band = band[:, 1::2]  # the high byte ("R;16N")
                    out[y0:y0 + ys, x0:x0 + xs,
                        _BAND_BYTES[mode].index(plane)] = band[:ys, :xs]
    if planes > 3 and mode == "RGBA" and tags.get(338, (None,))[0] in (0, 1):
        out = unpremultiply(out)
    return out


def _load_ycbcr(data, tags, compression, size, planar, bps, e):
    """PIL's _decodeAsRGBA: YCbCr read through libtiff's TIFFRGBAImage,
    one strip or row of tiles at a time. Its subsampled blocks (contiguous
    planes, 1, 2 or 4 across by 1, 2 or 4 down) or separate planes (no
    subsampling) are converted by libtiff's fixed-point tables (PIL asks
    for them top-left, as stored). This reader does not stop at errors: a
    strip or tile that fails reads as zeros, and only the first block of
    a row missing from the file fails the image."""
    w, h = size
    try:
        sub = tags.get(530, (2, 2))
        hs, vs = (sub, sub) if isinstance(sub, int) else sub[:2]
        if bps != (8, 8, 8) or not vs or (
                (hs, vs) != (1, 1) if planar == 2 else
                (hs, vs) not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1),
                                 (4, 2), (4, 4))):
            raise ValueError("Can not handle format")
        if _PARTIAL in tags:
            raise ValueError("directory cut short")
        tables = _ycbcr_tables(tags.get(529), tags.get(532))
        tiled, bw, bh, offs, cnts = _blocks(tags, w, h)
    except (TypeError, IndexError, KeyError, ValueError) as err:
        raise OSError("decoder error -2") from err
    n = hs * vs + 2
    row_blocks = -(-bw // hs)
    across = -(-w // bw) if tiled else 1
    down = -(-h // bh)
    out = np.zeros((h, w, 3), np.uint8)
    for by in range(down):
        y0 = by * bh
        rows = min(bh, h - y0)
        coded = bh if tiled else rows
        size = bw * coded if planar == 2 else -(-coded // vs) * row_blocks * n
        # libtiff reads a strip only as far as its rows, rounded up to the
        # subsampling, times a scanline of a block row's bytes over vs
        limit = size if tiled or planar == 2 else min(
            size, -(-coded // vs) * vs * (row_blocks * n // vs))
        got = None  # libtiff's buffer: zeroed at the block row's first read
        for bx in range(across):
            x0 = bx * bw
            for plane in range(3 if planar == 2 else 1):
                index = by * across + bx + plane * across * down
                first = got is None
                if first:
                    got = [np.zeros(size, np.uint8)
                           for _ in range(3 if planar == 2 else 1)]
                try:
                    _decode_block(data, tags, compression, offs, cnts, index,
                                  (bw, coded, 0), bps, planar, e,
                                  got[plane][:limit], None,
                                  not tiled and y0 + rows >= h)
                except JPEGUnsupported as err:
                    raise item16("TIFF JPEG variant") from err
                except _Missing as err:
                    if first:  # no buffer yet: TIFFRGBAImageGet fails
                        raise OSError("decoder error -2") from err
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


def _blocks(tags, w, h):
    """(tiled, block width, block height, offsets, byte counts) of the
    strips or tiles; ValueError where their size is not a positive
    integer."""
    tiled = 324 in tags
    if tiled:
        bw, bh = tags.get(322), tags.get(323)
        offs, cnts = tags[324], tags.get(325)
    else:
        bw, bh = w, tags.get(278, h)
        offs, cnts = tags[273], tags.get(279)
    if not isinstance(bw, int) or not isinstance(bh, int) or \
            bw <= 0 or bh <= 0:
        raise ValueError("block size")
    offs = offs if isinstance(offs, tuple) else (offs,)
    cnts = cnts if isinstance(cnts, tuple) else (
        () if cnts is None else (cnts,))
    return tiled, bw, bh, offs, cnts


class _Missing(ValueError):
    """libtiff's TIFFFillStrip / Tile failed: the strip or tile is not
    named, is empty or lies past the file's end."""


def _decode_block(data, tags, compression, offs, cnts, index, shape, bps,
                  planar, e, out, noeol, last):
    """libtiff's TIFFReadEncodedStrip / Tile of block ``index`` into
    ``out`` (a uint8 array of as many bytes as libtiff reads; ``shape``
    is the block's width, rows and scanline bytes); raises where it
    fails."""
    bw, rows, rowb = shape
    try:
        off, cnt = offs[index], cnts[index]
    except IndexError as err:
        raise _Missing("no such strip or tile") from err
    if not cnt or off + cnt > len(data):
        raise _Missing("strip or tile past the end of the file")
    raw = data[off:off + cnt]
    spp = 1 if planar == 2 else len(bps)
    need = len(out)
    if compression in _CCITT:
        if bps[0] != 1 or spp != 1:
            raise ValueError("CCITT takes one 1-bit sample")
        opts = tags.get(292 if compression == "group3" else 293, 0)
        opts = opts[0] if isinstance(opts, tuple) else opts
        if _cc_lib().cc_decode(
                raw, len(raw), _CCITT[compression], int(opts) & 0xFFFFFFFF,
                int(tags.get(266, 1) != 2), bw, rowb, rows, off,
                out.ctypes.data, ctypes.byref(noeol)) < 0:
            raise ValueError("CCITT data broken")
        return
    if tags.get(266, 1) == 2:
        # FillOrder 2: libtiff reverses the bits of the raw bytes first
        raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
    if compression == "jpeg":
        px = _jpeg_strip(raw, tags.get(347), tags.get(262, 0), bw, rows,
                         last, spp, bps[0])
        px = np.ascontiguousarray(px).reshape(-1)
        out[:len(px)] = px[:need]
        return
    if compression == "tiff_thunderscan":
        px = _thunder(raw, bw, rows, rowb, bps, out)
    else:
        px = _decompress(compression, raw, need)
    if len(px) < need:
        raise ValueError("short strip")
    predictor = tags.get(317, 1) if compression in _PREDICTED else 1
    if predictor != 1 and need != rows * ((bw * bps[0] * spp + 7) // 8):
        raise ValueError("a predictor on subsampled YCbCr")
    out[:] = np.frombuffer(_predict(px[:need], predictor, bps[:spp], bw,
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
        known = zstd.content_size(raw)
        return zstd.decompress(raw, known if need <= known <= 4 * need
                               else need)
    if compression == "lzma":
        import lzma  # the .xz stream libtiff writes per strip or tile
        return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(
            raw, max_length=need)
    if compression in ("tiff_adobe_deflate", "tiff_deflate"):
        return zlib.decompressobj().decompress(raw, need)
    raise ValueError(f"no {compression} decoder")


_TWO_BIT = (0, 1, 0, -1)
_THREE_BIT = (0, 1, 2, 3, 0, -3, -2, -1)


def _thunder(raw: bytes, width: int, rows: int, rowb: int, bps, buf
             ) -> bytes:
    """libtiff's ThunderDecode, row by row: 4-bit pixels from runs of the
    last one, 2-bit or 3-bit deltas, or raw values. A run that fills the
    row to its end writes nothing, as libtiff's does not, so those bytes
    keep what the buffer held."""
    if bps[0] != 4:
        raise ValueError("ThunderScan takes 4-bit samples")
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
                if npix < width:
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


def _predict(buf: bytes, predictor: int, bps, w: int, rows: int, e: str
             ) -> bytes:
    """libtiff's predictors, leaving native-order samples."""
    k = bps[0] // 8
    if predictor == 1:
        if bps[0] in (16, 32) and e == ">":
            return np.frombuffer(buf, ">u%d" % k).astype("<u%d" % k).tobytes()
        return buf
    if predictor == 2 and bps[0] in (8, 16, 32):
        a = np.frombuffer(buf, e + "u%d" % k).reshape(rows, w, len(bps))
        return _undo_hpredictor(a).astype("<u%d" % k).tobytes()
    if predictor == 3 and bps[0] in (32, 64):
        return _undo_fpredictor(buf, rows, w, len(bps),
                                np.dtype("<f%d" % k)).tobytes()
    raise ValueError(f"predictor {predictor}")


def _jpeg_strip(raw: bytes, tables, photometric: int, width: int,
                rows: int, last: bool, spp: int, bits: int) -> np.ndarray:
    """One JPEG strip or tile: the file's tables, then the strip's
    frame, decoded by the port's libjpeg-turbo-equal decoder. libtiff
    asks libjpeg for RGB from a YCbCr file (a JFIF marker makes the
    decoder take the components as YCbCr) and for the components as they
    are otherwise (an Adobe marker with transform 0)."""
    body = raw[2:] if raw[:2] == b"\xff\xd8" else raw
    head = b"\xff\xd8"
    if photometric == 6:
        head += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    else:
        head += b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    if isinstance(tables, tuple):
        tables = tables[0]
    if tables:
        t = bytes(tables)
        t = t[2:] if t[:2] == b"\xff\xd8" else t
        t = t[:-2] if t[-2:] == b"\xff\xd9" else t
        head += t
    stream = head + body
    # libtiff's JPEGPreDecode checks (the decoder takes 8-bit samples
    # only)
    jh, jw, sampling = jpeg_frame(stream)
    if jw == width and jh > rows and last:
        pass  # a last strip coded at full height: libtiff cuts it
    elif jw != width or jh != rows:
        raise ValueError("JPEG strip/tile size differs from the TIFF's")
    if len(sampling) != spp or bits != 8:
        raise ValueError("improper JPEG component count or precision")
    if photometric != 6 and any(s != (1, 1) for s in sampling):
        # libtiff reads such a file raw, downsampled (a sampling that
        # differs from the YCbCr tag is only its warning)
        raise ValueError("downsampled JPEG without YCbCr")
    return decode_jpeg_array(stream)[:rows]
