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
first). Compressed ones go through libtiff in PIL: LZW, Deflate and
PackBits with their predictors (``geotiff.py``'s), and
JPEG (compression 7) through the port's ``jpeg.cc``, each strip or tile
with the file's ``JPEGTables``, converted from YCbCr to RGB by the JPEG
decoder as PIL asks libtiff to (``JPEGCOLORMODE_RGB``); any failure
there is PIL's ``OSError`` "decoder error -2". Other compressions raise
:class:`UnsupportedFormat` naming ROADMAP queue 1 item 16. The EXIF
orientation is applied as ``ImageOps.exif_transpose`` does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .geotiff import (_ifd_entries, _ifd_value_bytes, _packbits_decode,
                      _undo_fpredictor, _undo_hpredictor)
from .jpeg import JPEGUnsupported, decode_jpeg_array, jpeg_frame
from .lzw import lzw_decode_native
from .pil_formats import (Opened, apply_palette, check_bomb, item16,
                          read_rows, row_bytes, unpack)

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
    if rawmode == "I;12":
        raise item16("TIFF 12-bit")
    arr = unpack(rawmode, buf, w, rows, stride)
    if mode == "I;16B":
        arr = arr.astype(">u2")
    return arr


def _chunks(tags: dict, w: int, h: int):
    """(offset, byte count, x, y, width, rows) of each strip or tile."""
    if 273 in tags:
        offs = tags[273] if isinstance(tags[273], tuple) else (tags[273],)
        cnts = tags.get(279, ())
        cnts = cnts if isinstance(cnts, tuple) else (cnts,)
        rps = tags.get(278, h)
        out = []
        y = 0
        for i, off in enumerate(offs):
            out.append((off, cnts[i] if i < len(cnts) else None, 0, y, w,
                        rps))
            y += rps
        return out
    offs = tags[324] if isinstance(tags[324], tuple) else (tags[324],)
    cnts = tags.get(325, ())
    cnts = cnts if isinstance(cnts, tuple) else (cnts,)
    tw, th = tags.get(322), tags.get(323)
    if not isinstance(tw, int) or not isinstance(th, int):
        raise ValueError("Invalid tile dimensions")
    out = []
    x = y = 0
    for i, off in enumerate(offs):
        out.append((off, cnts[i] if i < len(cnts) else None, x, y, tw, th))
        x += tw
        if x >= w:
            x, y = 0, y + th
    return out


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
            rb = (tw_ * bps[0] + 7) // 8
            st = stride or rb
            buf = read_rows(data, off, st, rows, rb)
            band = np.frombuffer(buf, np.uint8).reshape(rows, st)[:, :rb]
            if out.ndim == 3:
                out[y0:y1, x0:x1, "RGBA".index(rm) if rm in "RGBA"
                    else layer] = band
            else:
                out[y0:y1, x0:x1] = band
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


def _load_libtiff(data, tags, compression, mode, rawmode, size, planar, bps,
                  e):
    """PIL's libtiff decoder: each strip or tile decompressed, its
    predictor undone, unpacked with the native-order raw mode."""
    if compression not in ("tiff_lzw", "tiff_adobe_deflate", "tiff_deflate",
                           "packbits", "jpeg"):
        raise item16(f"TIFF compression {compression}")
    if planar == 2:
        raise item16("TIFF compressed separate planes")
    w, h = size
    try:
        if _PARTIAL in tags:
            raise ValueError("directory cut short")
        chunks = _chunks(tags, w, h)
    except (TypeError, IndexError, KeyError, ValueError) as err:
        raise OSError("decoder error -2") from err
    out = _mode_array(mode, w, h)
    predictor = tags.get(317, 1)
    nbits = sum(bps)
    tables = tags.get(347)
    for off, cnt, x0, y0, cw_, rows in chunks:
        if y0 >= h:
            break
        rows_here = rows if 324 in tags else min(rows, h - y0)
        row_len = (cw_ * nbits + 7) // 8
        need = row_len * rows_here
        if cnt is None or off + cnt > len(data):
            raise OSError("decoder error -2")
        raw = data[off:off + cnt]
        try:
            if compression == "jpeg":
                last = 324 not in tags and y0 + rows_here >= h
                px = _jpeg_strip(raw, tables, tags.get(262, 0), cw_,
                                 rows_here, last, len(bps), bps[0])
                buf = np.ascontiguousarray(px).tobytes()
            else:
                buf = _decompress(compression, raw, need)
                if len(buf) < need:
                    raise ValueError("short strip")
                buf = _predict(buf[:need], predictor, bps, cw_, rows_here, e)
        except JPEGUnsupported as err:
            raise item16("TIFF JPEG variant") from err
        except Exception as err:  # noqa: BLE001 -- libtiff's failure
            raise OSError("decoder error -2") from err
        arr = _unpack_mode(rawmode, buf, cw_, rows_here, row_len, mode)
        ys, xs = min(rows_here, h - y0), min(cw_, w - x0)
        out[y0:y0 + ys, x0:x0 + xs] = arr[:ys, :xs]
    return out


def _decompress(compression, raw, need):
    if compression == "tiff_lzw":
        return lzw_decode_native(raw, max_size=need)
    if compression == "packbits":
        return _packbits_decode(raw)
    return zlib.decompressobj().decompress(raw, need)


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
