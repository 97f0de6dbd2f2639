"""Which PIL opener takes a file's bytes, and what ``np.asarray`` of
``PIL.Image.open`` then gives or raises: the semantics of the JAX
package's ``decode_png`` / ``decode_jpeg`` (``_pil_decode``), without
PIL.

PIL 12.1's ``Image.open`` walks its openers in registration order: the
five formats it loads first (BMP, DIB, GIF, JPEG, PPM, PNG), then the
rest in its plugin list's order (:data:`ORDER`). An opener with an
accept check takes the bytes when the check passes; IM, IMT, IPTC,
PCD, SPIDER and TGA have none and try to parse any bytes. The walk goes
on to the next opener on ``SyntaxError``, ``IndexError``, ``TypeError``
or ``struct.error`` (the plugin's ``_open`` turning ``KeyError`` and
``EOFError`` into ``SyntaxError`` too); any other exception propagates.
No opener taking the bytes is :class:`UnidentifiedImageError`; an image
of more than 2 x ``MAX_IMAGE_PIXELS`` pixels is
:class:`DecompressionBombError`. Pixels are read later, by
``np.asarray``, so a file whose header parses and whose data ends early
fails there, with PIL's ``OSError``.

The header parsers here and in ``pil_formats.py`` are transcriptions of
Pillow 12.1.0's plugins (MIT-CMU licence). Formats the port decodes:
PNG, JPEG, GIF, BMP/DIB, JPEG 2000 (the port's codecs, their failures
mapped by kind: ``codec_errors.py``) and ICO/CUR here, TIFF
(``pil_tiff.py``), WebP (``webp.py``), and PPM, TGA, SGI, PCX, QOI, IM,
XBM, GBR and DDS (``pil_formats.py``, which also holds the failure
classes and the bomb check). The other openers are
identified as PIL identifies them and raise :class:`UnsupportedFormat`
naming ROADMAP queue 1 item 16, except where PIL itself refuses: its
BUFR, GRIB, HDF5 and WMF stubs, which open and then fail to load with
``OSError`` "cannot find loader for this ... file", and EPS, which PIL
renders through Ghostscript ("Unable to locate Ghostscript on paths"
where it has none, as on the JAX package's machines).
"""

from __future__ import annotations

import math
import struct
from typing import Callable, Optional

import numpy as np

from . import pil_formats as pf
from .bmp import BMPRefused, _parse, decode_bmp_array
from .codec_errors import NotEnoughImageData, TruncatedData, UnknownFilter
from .gif import decode_gif_array
from .jp2 import JP2Unsupported, decode_jp2, palette_rgb
from .jpeg import JPEGUnsupported, decode_jpeg_array
from .pil_formats import (MAX_IMAGE_PIXELS, DecompressionBombError, Opened,
                          Reader, UnsupportedFormat, check_bomb, i16be, i16le,
                          i32be, i32le, item16)
from .pil_tiff import open_tiff
from .png import _CID, decode_png_array
from .webp import open_webp

__all__ = ["DecompressionBombError", "MAX_IMAGE_PIXELS", "ORDER",
           "UnidentifiedImageError", "UnsupportedFormat", "check_bomb",
           "identify", "pil_decode"]

# Image.ID after the first Image.open of a process: preinit's formats,
# then init()'s
ORDER = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP", "BUFR",
         "CUR", "PCX", "DCX", "DDS", "EPS", "FITS", "FLI", "FTEX", "GBR",
         "GRIB", "HDF5", "JPEG2000", "ICNS", "ICO", "IM", "IMT", "IPTC",
         "MCIDAS", "MPEG", "TIFF", "MSP", "PCD", "PIXAR", "PSD", "QOI",
         "SGI", "SPIDER", "SUN", "TGA", "WEBP", "WMF", "XBM", "XPM",
         "XVTHUMB")


class UnidentifiedImageError(OSError):
    """No PIL opener takes the bytes (PIL's class of the same name)."""


def _safe_read(fp: Reader, size: int) -> bytes:
    if size <= 0:
        return b""
    data = fp.read(size)
    if len(data) < size:
        raise OSError("Truncated File Read")
    return data


# ------------------------------------------------------------------ PNG

_PNG_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L",
              (16, 0): "I;16", (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P",
              (2, 3): "P", (4, 3): "P", (8, 3): "P", (8, 4): "LA",
              (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}


def _is_cid(cid: bytes) -> bool:
    return len(cid) == 4 and all(c in _CID for c in cid)


def _png_header(data: bytes, start: int = 0) -> tuple:
    """PngImageFile._open's chunk walk up to the first IDAT: (mode,
    size). CRCs of the chunks before it are checked."""
    import zlib
    fp = Reader(data, start)
    if fp.read(8) != b"\x89PNG\r\n\x1a\n":
        raise SyntaxError("not a PNG file")
    mode = size = None
    while True:
        s = fp.read(8)
        cid = s[4:]
        length = i32be(s)
        if not _is_cid(cid):
            raise SyntaxError(f"broken PNG file (chunk {cid!r})")
        if cid == b"IDAT":
            break
        if cid == b"IEND":
            break
        body = _safe_read(fp, length)
        if cid == b"IHDR":
            if length < 13:
                raise ValueError("Truncated IHDR chunk")
            size = i32be(body), i32be(body, 4)
            mode = _PNG_MODES[(body[8], body[9])]
            if body[11]:
                raise SyntaxError("unknown filter category")
        elif cid in (b"acTL", b"fcTL", b"fdAT"):
            # animated PNGs: the first frame is the default image
            pass
        try:
            crc2 = i32be(fp.read(4))
        except struct.error as e:
            raise SyntaxError(
                f"broken PNG file (incomplete checksum in {cid!r})") from e
        if zlib.crc32(body, zlib.crc32(cid)) != crc2:
            raise SyntaxError(
                f"broken PNG file (bad header checksum in {cid!r})")
    if mode is None:
        raise SyntaxError("not identified by this opener")
    return mode, size


def _map_load(fn, data, broken: bool = False):
    """Run one of the port's codecs as PIL's loading stage: its failures
    become what PIL's loader raises, by their kind (``codec_errors.py``;
    ``broken``: always "broken data stream", as PIL's OpenJPEG decoder
    fails)."""
    try:
        return fn(data)
    except (MemoryError, RecursionError, SyntaxError):
        raise  # PIL's PNG loader lets a SyntaxError out
    except (JPEGUnsupported, JP2Unsupported) as e:
        raise UnsupportedFormat(str(e)) from e
    except Exception as e:  # noqa: BLE001 -- every failure is PIL's OSError
        if not broken:
            if isinstance(e, UnknownFilter):
                raise OSError("unrecognized data stream contents when "
                              "reading image file") from e
            if isinstance(e, NotEnoughImageData):
                raise ValueError("not enough image data") from e
            if isinstance(e, TruncatedData):
                raise OSError("image file is truncated") from e
        raise OSError("broken data stream when reading image file") from e


def open_png(data: bytes) -> Opened:
    mode, size = _png_header(data)
    return Opened("PNG", mode, size,
                  lambda: _squeeze(_map_load(decode_png_array, data)))


def _squeeze(arr: np.ndarray) -> np.ndarray:
    return arr[:, :, 0] if arr.ndim == 3 and arr.shape[2] == 1 else arr


# ----------------------------------------------------------------- JPEG

_SOF = {0xFFC0, 0xFFC1, 0xFFC2, 0xFFC3, 0xFFC5, 0xFFC6, 0xFFC7, 0xFFC9,
        0xFFCA, 0xFFCB, 0xFFCD, 0xFFCE, 0xFFCF, 0xFFDE}
_SKIP = {0xFFC4, 0xFFCC, 0xFFDA, 0xFFDC, 0xFFDD, 0xFFDF}
_NONE = {0xFFC8, *range(0xFFD0, 0xFFDA), *range(0xFFF0, 0xFFFE)}
_APP = set(range(0xFFE0, 0xFFF0)) | {0xFFFE}


def _jpeg_header(data: bytes) -> tuple:
    """JpegImageFile._open's marker walk up to the first scan: (mode,
    size)."""
    fp = Reader(data)
    if not fp.read(3).startswith(b"\xff\xd8\xff"):
        raise SyntaxError("not a JPEG file")
    s = b"\xff"
    mode = None
    size = (0, 0)
    while True:
        i = s[0]
        if i == 0xFF:
            s = s + fp.read(1)
            i = i16be(s)
        else:
            s = fp.read(1)
            continue
        if i in _SOF or i in _SKIP or i in _NONE or i in _APP or i == 0xFFDB:
            if i in _SOF:
                n = i16be(fp.read(2)) - 2
                b = _safe_read(fp, n)
                size = i16be(b, 3), i16be(b, 1)
                if b[0] != 8:
                    raise SyntaxError(f"cannot handle {b[0]}-bit layers")
                layers = b[5]
                mode = {1: "L", 3: "RGB", 4: "CMYK"}.get(layers)
                if mode is None:
                    raise SyntaxError(
                        f"cannot handle {layers}-layer images")
            elif i in _SKIP or i in _APP:
                n = i16be(fp.read(2)) - 2
                b = _safe_read(fp, n)
                if i == 0xFFEE and b.startswith(b"Adobe"):
                    i16be(b, 5)
            elif i == 0xFFDB:
                n = i16be(fp.read(2)) - 2
                b = _safe_read(fp, n)
                while len(b):
                    qt = 1 + (1 if b[0] // 16 == 0 else 2) * 64
                    if len(b) < qt:
                        raise SyntaxError("bad quantization table marker")
                    b = b[qt:]
            if i == 0xFFDA:
                break
            s = fp.read(1)
        elif i in (0, 0xFFFF):
            s = b"\xff"
        elif i == 0xFF00:
            s = fp.read(1)
        else:
            raise SyntaxError("no marker found")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("not identified by this opener")
    return mode, size


def open_jpeg(data: bytes) -> Opened:
    mode, size = _jpeg_header(data)
    return Opened("JPEG", mode, size,
                  lambda: _squeeze(_map_load(decode_jpeg_array, data)))


# ------------------------------------------------------------------ GIF

def _gif_header(data: bytes) -> tuple:
    """GifImageFile._open and its _seek(0): up to the first image
    descriptor."""
    fp = Reader(data)
    s = fp.read(13)
    if not s.startswith((b"GIF87a", b"GIF89a")):
        raise SyntaxError("not a GIF file")
    size = i16le(s, 6), i16le(s, 8)
    flags = s[10]
    if flags & 128:
        fp.read(3 << ((flags & 7) + 1))

    def block():
        b = fp.read(1)
        if b and b[0]:
            return fp.read(b[0])
        return None
    s = fp.read(1)
    if not s or s == b";":
        raise EOFError("no more images in GIF file")
    found = False
    while True:
        if not s:
            s = fp.read(1)
        if not s or s == b";":
            break
        elif s == b"!":
            s = fp.read(1)
            b = block()
            if s[0] == 249 and b is not None:
                b[0]
                i16le(b, 1)
            elif s[0] == 254:
                while b:
                    b = block()
                s = b""
                continue
            while block():
                pass
        elif s == b",":
            s = fp.read(9)
            x0, y0 = i16le(s, 0), i16le(s, 2)
            x1, y1 = x0 + i16le(s, 4), y0 + i16le(s, 6)
            if x1 > size[0] or y1 > size[1]:
                size = max(x1, size[0]), max(y1, size[1])
                check_bomb(size)
            fl = s[8]
            if fl & 128:
                fp.read(3 << ((fl & 7) + 1))
            fp.read(1)[0]
            found = True
            break
        s = b""
    if not found:
        raise EOFError("image not found in GIF frame")
    return size, fp.tell()


def open_gif(data: bytes) -> Opened:
    size, blocks = _gif_header(data)

    def load():
        if data[blocks - 1] > 12:
            # the LZW code size PIL's decoder refuses
            raise OSError("codec configuration error when reading image "
                          "file")
        arr = _squeeze(_map_load(decode_gif_array, data))
        # PIL's decoder reads the data sub-blocks up to their terminator
        pos = blocks
        while pos < len(data) and data[pos]:
            pos += 1 + data[pos]
            if pos > len(data):
                raise OSError("image file is truncated")
        return arr
    return Opened("GIF", "P", size, load)


# ------------------------------------------------------------- BMP, DIB

_BIT2MODE = {1: "P", 4: "P", 8: "P", 16: "RGB", 24: "RGB", 32: "RGB"}


def _dib_header(data: bytes, start: int):
    """BmpImageFile._bitmap's reads: (header size, width, height, bits,
    compression, colours, palette padding, data offset) or what PIL
    raises."""
    fp = Reader(data, start)
    hsize = i32le(fp.read(4))
    hdr = _safe_read(fp, hsize - 4)
    if hsize == 12:
        w, h, bits = i16le(hdr, 0), i16le(hdr, 2), i16le(hdr, 6)
        comp, colors, pad = 0, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        flip = hdr[7] == 0xFF
        w = i32le(hdr, 0)
        h = i32le(hdr, 4) if not flip else 2 ** 32 - i32le(hdr, 4)
        bits, comp = i16le(hdr, 10), i32le(hdr, 12)
        colors, pad = i32le(hdr, 28), 4
        if comp == 3 and len(hdr) < 48:
            for _ in range(3):
                i32le(fp.read(4))
    else:
        raise OSError(f"Unsupported BMP header type ({hsize})")
    colors = colors or (1 << bits)
    if bits not in _BIT2MODE:
        raise OSError(f"Unsupported BMP pixel depth ({bits})")
    if comp not in (0, 1, 2, 3):
        raise OSError(f"Unsupported BMP compression ({comp})")
    if bits <= 8 and not 0 < colors <= 65536:
        raise OSError(f"Unsupported BMP Palette size ({colors})")
    pal_end = fp.tell() + (pad * colors if bits <= 8 else 0)
    return hsize, w, h, bits, comp, colors, pad, pal_end


def open_bmp(data: bytes) -> Opened:
    fp = Reader(data)
    head = fp.read(14)
    if not head.startswith(b"BM"):
        raise SyntaxError("Not a BMP file")
    i32le(head, 10)
    hsize, w, h, bits, comp, colors, pad, _ = _dib_header(data, 14)
    f = _parse_at_open(data)
    mode = "RGBA" if f and f.get("alpha") else ("P" if bits <= 8 else "RGB")
    return Opened("BMP", mode, (w, h), lambda: _squeeze(_map_load(
        decode_bmp_array, _pad_last_row(data, f, w, h, bits))))


def _parse_at_open(bmp: bytes):
    """The port's BMP header parse, raising at open only what PIL's
    ``_bitmap`` raises there ("Unsupported BMP ..."); what PIL refuses
    when it loads (an RLE file of more than 8 bits) waits for the
    load."""
    try:
        return _parse(bmp)
    except BMPRefused as e:
        raise OSError(str(e)) from e
    except ValueError:
        return None


def _pad_last_row(bmp: bytes, f, w: int, h: int, bits: int) -> bytes:
    """PIL's raw decoder does not read the padding after the last row:
    a file that ends inside it decodes, so the port's decoder gets the
    padding filled in."""
    if f is None or f["compression"] not in (0, 3):
        return bmp
    stride = ((w * bits + 31) >> 3) & ~3
    need = f["offset"] + (h - 1) * stride + (w * bits + 7) // 8
    full = f["offset"] + h * stride
    if need <= len(bmp) < full:
        return bmp + bytes(full - len(bmp))
    return bmp


def dib_as_bmp(data: bytes, start: int, rows: Optional[int] = None):
    """A BMP file of the DIB at ``start`` (PIL's DibImageFile, its data
    right after the header, palette and masks), with ``rows`` rows."""
    hsize, w, h, bits, comp, colors, pad, pal_end = _dib_header(data, start)
    dib = bytearray(data[start:])
    if rows is not None and hsize != 12:
        if h != i32le(dib, 8):  # top-down
            struct.pack_into("<i", dib, 8, -rows)
        else:
            struct.pack_into("<I", dib, 8, rows)
    elif rows is not None:
        struct.pack_into("<H", dib, 6, rows)
    offset = 14 + (pal_end - start)
    head = b"BM" + struct.pack("<I", 14 + len(dib)) + b"\0\0\0\0" + \
        struct.pack("<I", offset)
    return bytes(head) + bytes(dib), (w, h, bits, offset - 14 + start)


def open_dib_at(data: bytes, start: int, fmt: str = "DIB",
                cur_offset: Optional[int] = None) -> Opened:
    """DibImageFile at ``start``; its ``load`` honours ``info["rows"]``
    (ICO and CUR read half the height the header gives)."""
    bmp, (w, h, bits, data_at) = dib_as_bmp(data, start)
    f = _parse_at_open(bmp)
    opened = Opened(fmt, "P" if bits <= 8 else "RGB", (w, h))
    opened.info["offset"] = data_at
    rgba = bits == 32 and cur_offset == 22 and f is not None and \
        f["compression"] == 0
    if rgba:
        opened.mode = "RGBA"

    def load():
        rows = opened.info.get("rows")
        src, _ = dib_as_bmp(data, start, rows)
        src = _pad_last_row(src, _parse_at_open(src), w, rows or h,
                            bits)
        arr = _squeeze(_map_load(decode_bmp_array, src))
        if rgba:
            hh = rows or h
            raw = src[14 + (data_at - start):][:w * hh * 4]
            a = np.frombuffer(raw, np.uint8).reshape(hh, w, 4)[::-1, :, 3]
            arr = np.dstack([arr, a])
        return arr
    opened.load = load
    return opened


def open_dib(data: bytes) -> Opened:
    return open_dib_at(data, 0)


def open_cur(data: bytes) -> Opened:
    fp = Reader(data)
    s = fp.read(6)
    if not s.startswith(b"\0\0\2\0"):
        raise SyntaxError("not a CUR file")
    m = b""
    for _ in range(i16le(s, 4)):
        e = fp.read(16)
        if not m:
            m = e
        elif e[0] > m[0] and e[1] > m[1]:
            m = e
    if not m:
        raise TypeError("No cursors were found")
    off = i32le(m, 12)
    opened = open_dib_at(data, off, "CUR", cur_offset=off)
    w, h = opened.size
    opened.size = (w, h // 2)
    opened.info["rows"] = h // 2
    return opened


def open_ico(data: bytes) -> Opened:
    """``IcoImageFile._open``: the largest entry (the least colour depth
    among equals), loaded at open time as PIL does."""
    fp = Reader(data)
    s = fp.read(6)
    if not s.startswith(b"\0\0\1\0"):
        raise SyntaxError("not an ICO file")
    entries = []
    for _ in range(i16le(s, 4)):
        e = fp.read(16)
        width = e[0] or 256
        height = e[1] or 256
        nb_color = e[2]
        bpp = i16le(e, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) \
            or 256
        entries.append(dict(width=width, height=height, bpp=bpp,
                            size=i32le(e, 8), offset=i32le(e, 12),
                            square=width * height, depth=depth))
    entries.sort(key=lambda x: x["depth"])
    entries.sort(key=lambda x: x["square"], reverse=True)
    head = entries[0]  # IndexError without entries, as PIL
    off = head["offset"]
    if data[off:off + 8] == b"\x89PNG\r\n\x1a\n":
        sub = data[off:]
        mode, size = _png_header(sub)
        check_bomb(size)
        arr = _squeeze(_map_load(decode_png_array, sub))
        return Opened("ICO", mode, (arr.shape[1], arr.shape[0]),
                      lambda: arr)
    dib = open_dib_at(data, off, "ICO")
    w, h2 = dib.size
    h = int(h2 / 2)
    check_bomb((w, h2))
    if head["bpp"] == 32:
        o = dib.info["offset"]
        raw = data[o:o + w * h * 4][3::4]
        if len(raw) < w * h:
            raise ValueError("buffer is not large enough")
        alpha = np.frombuffer(raw, np.uint8)[:w * h].reshape(h, w)[::-1]
    else:
        wm = w + (32 - w % 32 if w % 32 else 0)
        total = int((wm * h) / 8)
        mask_at = off + head["size"] - total
        if mask_at < 0:
            raise ValueError(f"negative seek value {mask_at}")
        mask = data[mask_at:mask_at + total]
        # PIL's raw decoder needs no padding after the last row
        if len(mask) < (h - 1) * int(wm / 8) + (w + 7) // 8:
            raise ValueError("not enough image data")
        mask = mask + bytes(total - len(mask))
        bits = np.unpackbits(np.frombuffer(mask, np.uint8)[:wm // 8 * h]
                             .reshape(h, wm // 8), axis=1)[:, :w]
        alpha = np.where(bits, 0, 255).astype(np.uint8)[::-1]
    dib.info["rows"] = h
    rgb = dib.load()  # the DIB's own failures come before the 4 bands
    if rgb.dtype == bool:
        rgb = rgb.astype(np.uint8) * 255
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[:, :, None], 3, 2)
    rgba = np.dstack([rgb[:, :, :3], alpha])
    return Opened("ICO", "RGBA", (w, h), lambda: rgba)


# ------------------------------------------------------------ JPEG 2000

class _Boxes:
    """Jpeg2KImagePlugin.BoxReader."""

    def __init__(self, fp: Reader, length: int = -1):
        self.fp, self.length = fp, length
        self.has_length = length >= 0
        self.remaining = -1

    def _can_read(self, n):
        if self.has_length and self.fp.tell() + n > self.length:
            return False
        if self.remaining >= 0:
            return n <= self.remaining
        return True

    def read_bytes(self, n):
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        b = self.fp.read(n)
        if len(b) < n:
            raise OSError(f"Expected to read {n} bytes but only got "
                          f"{len(b)}.")
        if self.remaining > 0:
            self.remaining -= n
        return b

    def fields(self, fmt):
        return struct.unpack(fmt, self.read_bytes(struct.calcsize(fmt)))

    def sub(self):
        size = self.remaining
        return _Boxes(Reader(self.read_bytes(size)), size)

    def has_next(self):
        if self.has_length:
            return self.fp.tell() + self.remaining < self.length
        return True

    def next_type(self):
        if self.remaining > 0:
            self.fp.seek(self.remaining, 1)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        if lbox == 1:
            lbox = self.fields(">Q")[0]
            hlen = 16
        else:
            hlen = 8
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _jp2_header(data: bytes) -> tuple:
    fp = Reader(data)
    sig = fp.read(4)
    if sig == b"\xff\x4f\xff\x51":
        hdr = fp.read(2)
        lsiz = i16be(hdr)
        siz = hdr + fp.read(lsiz - 2)
        (_, _, xs, ys, xo, yo, _, _, _, _, csiz) = struct.unpack_from(
            ">HHIIIIIIIIH", siz)
        size = (xs - xo, ys - yo)
        if csiz == 1:
            mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) \
                + 1 > 8 else "L"
        else:
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(csiz)
            if mode is None:
                raise SyntaxError("unable to determine J2K image mode")
        _jp2_comment(fp)
        return mode, size
    sig = sig + fp.read(8)
    if sig != b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        raise SyntaxError("not a JPEG 2000 file")
    reader = _Boxes(fp)
    header = None
    while reader.has_next():
        t = reader.next_type()
        if t == b"jp2h":
            header = reader.sub()
            break
        elif t == b"ftyp":
            reader.fields(">4s")
    if header is None:
        raise AssertionError()
    size = mode = nc = None
    while header.has_next():
        t = header.next_type()
        if t == b"ihdr":
            hh, ww, nc, bpc = header.fields(">IIHB")
            size = (ww, hh)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            else:
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif t == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif t == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                for _ in range(ne):
                    header.fields(">" + "B" * npc)
                mode = "P" if mode == "L" else "PA"
        elif t == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
        fp.seek(i16be(fp.read(2)) - 2, 1)
        _jp2_comment(fp)
    return mode, size


def _jp2_comment(fp: Reader) -> None:
    """Jpeg2KImageFile._parse_comment: the main header's markers up to
    the first tile part or a comment."""
    while True:
        marker = fp.read(2)
        if not marker:
            break
        typ = marker[1]
        if typ in (0x90, 0xD9):
            break
        length = i16be(fp.read(2))
        if typ == 0x64:
            fp.read(length - 2)
            break
        fp.seek(length - 2, 1)


def open_jp2(data: bytes) -> Opened:
    mode, size = _jp2_header(data)

    def load():
        def dec(d):
            arr = decode_jp2(d).array
            table = palette_rgb(d)
            return arr if table is None else table[arr[:, :, 0]]
        return _squeeze(_map_load(dec, data, broken=True))
    return Opened("JPEG2000", mode, size, load)


# -------------------------------------------------------- stub openers

def _stub(fmt: str, magic_len: int, accept) -> Callable:
    def opener(data: bytes) -> Opened:
        if not accept(data[:magic_len]):
            raise SyntaxError(f"Not a {fmt} file")

        def load():
            raise OSError(f"cannot find loader for this {fmt} file")
        return Opened(fmt, "F", (1, 1), load)
    return opener


def _open_wmf(data: bytes) -> Opened:
    s = data[:80]
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        inch = i16le(s, 14)
        if inch == 0:
            raise ValueError("Invalid inch")
        x0, y0, x1, y1 = struct.unpack_from("<hhhh", s, 6)
        size = ((x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch)
        if s[22:26] != b"\x01\x00\t\x00":
            raise SyntaxError("Unsupported WMF file format")
    elif s.startswith(b"\x01\x00\x00\x00") and s[40:44] == b" EMF":
        x0, y0, x1, y1 = struct.unpack_from("<iiii", s, 8)
        frame = struct.unpack_from("<iiii", s, 24)
        size = x1 - x0, y1 - y0
        xdpi = 2540.0 * (x1 - x0) / (frame[2] - frame[0])
        ydpi = 2540.0 * (y1 - y0) / (frame[3] - frame[1])
        del xdpi, ydpi
    else:
        raise SyntaxError("Unsupported file format")

    def load():
        raise OSError("cannot find loader for this WMF file")
    return Opened("WMF", "RGB", size, load)


def _open_eps(data: bytes) -> Opened:
    """EpsImageFile._open; PIL then renders through Ghostscript, which
    the JAX package's machine has not: its load raises "Unable to locate
    Ghostscript on paths", and so does the port's."""
    import re
    split = re.compile(r"^%%([^:]*):[ \t]*(.*)[ \t]*$")
    field = re.compile(r"^%[%!\w]([^:]*)[ \t]*$")
    fp = Reader(data)
    s = fp.read(4)
    if s == b"%!PS":
        offset = 0
    elif i32le(s) == 0xC6D3D0C5:
        offset = i32le(fp.read(8))
    else:
        raise SyntaxError("not an EPS file")
    fp.seek(offset)
    info = {}
    mode = "RGB"
    box = size = None
    buf = bytearray(255)
    n = 0
    header, trailer_comments, trailer = True, False, False

    def check_header():
        if "PS-Adobe" not in info:
            raise SyntaxError('EPS header missing "%!PS-Adobe" comment')
        if "BoundingBox" not in info:
            raise SyntaxError('EPS header missing "%%BoundingBox" comment')

    def read_comment(text):
        nonlocal box, trailer_comments
        m = split.match(text)
        if not m:
            return False
        k, v = m.group(1, 2)
        info[k] = v
        if k == "BoundingBox":
            if v == "(atend)":
                trailer_comments = True
            elif not box or (trailer and trailer_comments):
                try:
                    box = [int(float(i)) for i in v.split()]
                except Exception:  # noqa: BLE001 -- as PIL
                    pass
        return True

    while True:
        byte = fp.read(1)
        if byte == b"":
            if n == 0:
                if header:
                    check_header()
                break
        elif byte in b"\r\n":
            if n == 0:
                continue
        else:
            if n >= 255:
                if buf[0] == ord("%"):
                    raise SyntaxError("not an EPS file")
                if header:
                    check_header()
                    header = False
                n = 0
            buf[n] = byte[0]
            n += 1
            continue
        line = bytes(buf[:n])
        if header:
            if buf[0] != ord("%") or line[:13] == b"%%EndComments":
                check_header()
                header = False
                continue
            text = str(line, "latin-1")
            if not read_comment(text):
                m = field.match(text)
                if m:
                    k = m.group(1)
                    if k.startswith("PS-Adobe"):
                        info["PS-Adobe"] = k[9:]
                    else:
                        info[k] = ""
                elif text[0] == "%":
                    pass
                else:
                    raise OSError("bad EPS header")
        elif line[:11] == b"%ImageData:":
            if size:
                n = 0
                continue
            columns, rows, depth, mode_id = (
                int(v) for v in buf[11:n].split(None, 7)[:4])
            if depth == 1:
                mode = "1"
            elif depth == 8:
                mode = {1: "L", 2: "LAB", 3: "RGB", 4: "CMYK"}[mode_id]
            else:
                break
            size = columns, rows
        elif line[:5] == b"%%EOF":
            break
        elif trailer and trailer_comments:
            read_comment(str(line, "latin-1"))
        elif line[:9] == b"%%Trailer":
            trailer = True
        elif line[:14] == b"%%BeginBinary:":
            fp.seek(int(buf[14:n]), 1)
        n = 0
    if not box:
        raise OSError("cannot determine EPS bounding box")
    size = size or (box[2] - box[0], box[3] - box[1])

    def load():
        raise OSError("Unable to locate Ghostscript on paths")
    return Opened("EPS", mode, size, load)


# ------------------------------------------------ permissive, unported

def _open_imt(data: bytes) -> Opened:
    import re
    field = re.compile(rb"([a-z]*) ([^ \r\n]*)")
    fp = Reader(data)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    xsize = ysize = 0
    mode = ""
    tile = False
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            tile = True
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = field.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
        elif k == b"height":
            ysize = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    del tile
    return Opened("IMT", mode, (xsize, ysize))


def _open_iptc(data: bytes) -> Opened:
    fp = Reader(data)
    info = {}

    def getint(key):
        c = info[key]
        return i32be((b"\0\0\0\0" + c)[-4:])

    tag = None
    while True:
        s = fp.read(5)
        if not s.strip(b"\x00"):
            tag = None
            break
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise SyntaxError("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise OSError("illegal field length in IPTC/NAA file")
        elif size == 128:
            size = 0
        elif size > 128:
            size = i32be((b"\0\0\0\0" + fp.read(size - 128))[-4:])
        else:
            size = i16be(s, 3)
        if tag == (8, 10):
            break
        tagdata = fp.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(tagdata)
            else:
                info[tag] = [info[tag], tagdata]
        else:
            info[tag] = tagdata
    layers = info[(3, 60)][0]
    component = info[(3, 60)][1]
    mode = ""
    if layers == 1 and not component:
        mode = "L"
    elif layers == 3 and component:
        mode = "RGB"
    elif layers == 4 and component:
        mode = "CMYK"
    if mode == "" and (3, 65) in info:
        info[(3, 65)][0]
    size = getint((3, 20)), getint((3, 30))
    if getint((3, 120)) not in (1, 5):
        raise OSError("Unknown IPTC image compression")
    return Opened("IPTC", mode, size)


def _open_mcidas(data: bytes) -> Opened:
    """McIdasImagePlugin's area directory: identified, not decoded."""
    s = data[:256]
    if not s.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04") or \
            len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = [0] + list(struct.unpack("!64i", s))
    mode = {1: "L", 2: "I;16B", 4: "I"}.get(w[11])
    if mode is None:
        raise SyntaxError("unsupported McIdas format")
    if w[10] > 0 and w[9] > 0:
        raise item16("MCIDAS")
    return Opened("MCIDAS", mode, (w[10], w[9]))


def _open_pcd(data: bytes) -> Opened:
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    orientation = s[1538] & 3
    return Opened("PCD", "RGB", (512, 768) if orientation in (1, 3)
                  else (768, 512))


def _spider_header(t):
    h = (99,) + t

    def is_int(f):
        try:
            i = int(f)
            return 1 if f - i == 0 else 0
        except (ValueError, OverflowError):
            return 0
    for i in (1, 2, 5, 12, 13, 22, 23):
        if not is_int(h[i]):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    if labbyt != labrec * lenbyt:
        return 0
    return labbyt


def _open_spider(data: bytes) -> Opened:
    f = data[:27 * 4]
    try:
        t = struct.unpack(">27f", f)
        hdrlen = _spider_header(t)
        if hdrlen == 0:
            t = struct.unpack("<27f", f)
            hdrlen = _spider_header(t)
        if hdrlen == 0:
            raise SyntaxError("not a valid Spider file")
    except struct.error as e:
        raise SyntaxError("not a valid Spider file") from e
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if not ((istack == 0 and imgnumber == 0) or (istack > 0 and imgnumber == 0)
            or (istack == 0 and imgnumber > 0)):
        raise SyntaxError("inconsistent stack header values")
    return Opened("SPIDER", "F", size)


# ------------------------------------------------------------ the walk

def _accept_prefix(prefixes):
    return lambda p: p.startswith(prefixes)


def _avif_accept(p):
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                               b"msf1")


def _webp_accept(p):
    return p.startswith(b"RIFF") and p[8:12] == b"WEBP" and \
        p[12:16] in (b"VP8 ", b"VP8X", b"VP8L")


def _item16_opener(fmt):
    def opener(data: bytes) -> Opened:
        raise item16(fmt)
    return opener


def _eps_accept(p):
    return p.startswith(b"%!PS") or (len(p) >= 4 and i32le(p) == 0xC6D3D0C5)


# name -> (accept or None, opener)
_OPENERS = {
    "BMP": (_accept_prefix(b"BM"), open_bmp),
    "DIB": (lambda p: i32le(p) in (12, 40, 52, 56, 64, 108, 124), open_dib),
    "GIF": (_accept_prefix((b"GIF87a", b"GIF89a")), open_gif),
    "JPEG": (_accept_prefix(b"\xff\xd8\xff"), open_jpeg),
    "PPM": (pf.ppm_accept, pf.open_ppm),
    "PNG": (_accept_prefix(b"\x89PNG\r\n\x1a\n"), open_png),
    "AVIF": (_avif_accept, _item16_opener("AVIF")),
    "BLP": (_accept_prefix((b"BLP1", b"BLP2")), _item16_opener("BLP")),
    "BUFR": (_accept_prefix((b"BUFR", b"ZCZC")),
             _stub("BUFR", 4, _accept_prefix((b"BUFR", b"ZCZC")))),
    "CUR": (_accept_prefix(b"\0\0\2\0"), open_cur),
    "PCX": (pf.pcx_accept, pf.open_pcx),
    "DCX": (lambda p: len(p) >= 4 and i32le(p) == 0x3ADE68B1,
            _item16_opener("DCX")),
    "DDS": (_accept_prefix(b"DDS "), pf.open_dds),
    "EPS": (_eps_accept, _open_eps),
    "FITS": (_accept_prefix(b"SIMPLE"), _item16_opener("FITS")),
    "FLI": (lambda p: len(p) >= 16 and i16le(p, 4) in (0xAF11, 0xAF12)
            and i16le(p, 14) in (0, 3), _item16_opener("FLI")),
    "FTEX": (_accept_prefix(b"FTEX"), _item16_opener("FTEX")),
    "GBR": (pf.gbr_accept, pf.open_gbr),
    "GRIB": (lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
             _stub("GRIB", 8, lambda p: len(p) >= 8 and p.startswith(b"GRIB")
                   and p[7] == 1)),
    "HDF5": (_accept_prefix(b"\x89HDF\r\n\x1a\n"),
             _stub("HDF5", 8, _accept_prefix(b"\x89HDF\r\n\x1a\n"))),
    "JPEG2000": (_accept_prefix((b"\xff\x4f\xff\x51",
                                 b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")),
                 open_jp2),
    "ICNS": (_accept_prefix(b"icns"), _item16_opener("ICNS")),
    "ICO": (_accept_prefix(b"\0\0\1\0"), open_ico),
    "IM": (None, pf.open_im),
    "IMT": (None, _open_imt),
    "IPTC": (None, _open_iptc),
    "MCIDAS": (_accept_prefix(b"\x00\x00\x00\x00\x00\x00\x00\x04"),
               _open_mcidas),
    "MPEG": (_accept_prefix(b"\x00\x00\x01\xb3"), _item16_opener("MPEG")),
    "TIFF": (_accept_prefix((b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
                             b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")),
             open_tiff),
    "MSP": (_accept_prefix((b"DanM", b"LinS")), _item16_opener("MSP")),
    "PCD": (None, _open_pcd),
    "PIXAR": (_accept_prefix(b"\200\350\000\000"), _item16_opener("PIXAR")),
    "PSD": (_accept_prefix(b"8BPS"), _item16_opener("PSD")),
    "QOI": (_accept_prefix(b"qoif"), pf.open_qoi),
    "SGI": (pf.sgi_accept, pf.open_sgi),
    "SPIDER": (None, _open_spider),
    "SUN": (lambda p: len(p) >= 4 and i32be(p) == 0x59A66A95,
            _item16_opener("SUN")),
    "TGA": (None, pf.open_tga),
    "WEBP": (_webp_accept, open_webp),
    "WMF": (_accept_prefix((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")),
            _open_wmf),
    "XBM": (pf.xbm_accept, pf.open_xbm),
    "XPM": (_accept_prefix(b"/* XPM */"), _item16_opener("XPM")),
    "XVTHUMB": (_accept_prefix(b"P7 332"), _item16_opener("XVTHUMB")),
}
# openers whose file PIL would open, but the port cannot tell without
# parsing what it does not decode: identification stops at them
_UNPORTED_PERMISSIVE = {"IMT", "IPTC", "PCD", "SPIDER"}


def identify(data: bytes) -> Opened:
    """PIL's opener walk over ``data``: the first opener that takes it,
    with its mode, size and loader, or what PIL raises."""
    prefix = data[:16]
    for name in ORDER:
        accept, opener = _OPENERS[name]
        try:
            if accept is not None and not accept(prefix):
                continue
            try:
                opened = opener(data)
            except (IndexError, TypeError, KeyError, EOFError,
                    struct.error) as e:
                raise SyntaxError(str(e)) from e
            if not opened.mode or opened.size[0] <= 0 or opened.size[1] <= 0:
                raise SyntaxError("not identified by this opener")
            check_bomb(opened.size)
        except (SyntaxError, IndexError, TypeError, struct.error):
            continue
        if name in _UNPORTED_PERMISSIVE:
            raise item16(name)
        return opened
    raise UnidentifiedImageError(
        "cannot identify image file <bytes of length "
        f"{len(data)}>")


def pil_decode(data: bytes) -> np.ndarray:
    """``np.asarray(Image.open(bytes))``, a "P" image converted to RGB
    first, with a band axis added to 2-D results: the JAX package's
    ``_pil_decode``."""
    opened = identify(data)
    if opened.load is None:
        raise item16(opened.fmt)
    try:
        arr = opened.load()
    except UnsupportedFormat:
        raise
    except NotImplementedError as e:
        # a raw mode or block format of a ported opener not decoded yet
        raise item16(f"{opened.fmt} {e}") from e
    if arr.dtype == bool:
        # np.asarray of a mode "1" image: its bytes are 0 and 255
        arr = (arr.view(np.uint8) != 0).astype(np.uint8) * np.uint8(255)
        arr = arr.view(bool)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr
