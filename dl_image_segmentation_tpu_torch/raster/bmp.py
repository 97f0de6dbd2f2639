"""BMP decoder of the port (numpy, no PIL).

Returns what the JAX package's decode (PIL, palette images expanded to
RGB) returns:

* headers of 12 (OS/2 core), 40, 52, 56, 64, 108 and 124 bytes; rows
  bottom-up, or top-down when the height's top byte is 0xFF;
* 1, 4 and 8 bits a pixel through the palette: a palette that is the
  identity grey ramp (entries 0 and 255 for 1 bit) is no palette, and
  the pixels decode to 1 band (bool for 1 bit, PIL's mode "1"; a 4-bit
  one is read as 8-bit rows, PIL's quirk); any other palette decodes to
  RGB, an index past its end being black;
* 16 bits as 5-5-5 (or 5-6-5 through BITFIELDS), each channel scaled to
  8 bits as ``c * 255 // max``; 24 bits BGR; 32 bits BGRX as RGB, or the
  BITFIELDS layouts PIL takes (RGBA when the alpha mask is set).

RLE8 and RLE4 compression decode as PIL's ``BmpRleDecoder`` does: runs
cut at the row's end, the end-of-line, end-of-bitmap and delta escapes
(PIL reads a delta's two bytes and then two more, and moves by the
second pair), absolute runs padded to a 16-bit word of the file, RLE4's
high nibble first, rows bottom-up unless the height says top-down; data
that ends before the image is full raises "not enough image data". The
palette then maps the indices as for uncompressed files. What PIL
refuses (other depths, compressions and bitfield layouts) raises
:class:`BMPError`, as do truncated files.
"""

from __future__ import annotations

import struct

import numpy as np

from .codec_errors import NotEnoughImageData, TruncatedData
from .png import MAX_PIXELS

__all__ = ["BMPError", "bmp_layout", "decode_bmp_array"]

_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# the 32-bit BITFIELDS masks (r, g, b, a) PIL takes
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
    (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)}


class BMPError(ValueError):
    """A BMP that does not parse or decode."""


class BMPRefused(BMPError):
    """A header PIL's BMP opener refuses ("Unsupported BMP ...", its
    OSError at open)."""


class BMPTruncated(BMPError, TruncatedData):
    """A BMP whose header or pixel data ends early."""


class BMPNotEnoughData(BMPError, NotEnoughImageData):
    """An RLE stream that ends before the image is whole."""


def _parse(data: bytes) -> dict:
    if len(data) < 18 or data[:2] != b"BM":
        raise BMPError("not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if hsize not in _HEADERS:
        raise BMPRefused(f"Unsupported BMP header type ({hsize})")
    hdr = data[18:14 + hsize]
    if len(hdr) < hsize - 4:
        raise BMPTruncated("image file is truncated (BMP header)")
    f = {"offset": offset, "hsize": hsize, "alpha": False}
    if hsize == 12:
        f["width"], f["height"], _, f["bits"] = struct.unpack("<HHHH", hdr[:8])
        f["compression"], f["colors"], f["pad"], f["top_down"] = 0, 0, 3, False
    else:
        f["top_down"] = hdr[7] == 0xFF
        w, h = struct.unpack("<II", hdr[:8])
        f["width"], f["height"] = w, (2 ** 32 - h if f["top_down"] else h)
        (f["bits"], f["compression"]) = struct.unpack("<HI", hdr[10:16])
        (f["colors"],) = struct.unpack("<I", hdr[28:32])
        f["pad"] = 4
        if f["compression"] == 3:  # BITFIELDS
            if len(hdr) >= 48:
                n = 4 if len(hdr) >= 52 else 3
                masks = struct.unpack(f"<{n}I", hdr[36:36 + 4 * n])
                masks = masks + (0,) * (4 - n)
            else:
                extra = data[14 + hsize:14 + hsize + 12]
                if len(extra) < 12:
                    raise BMPTruncated("image file is truncated (BMP masks)")
                masks = struct.unpack("<3I", extra) + (0,)
            f["masks"] = masks
    bits, comp = f["bits"], f["compression"]
    if bits not in (1, 4, 8, 16, 24, 32):
        raise BMPRefused(f"Unsupported BMP pixel depth ({bits})")
    f["colors"] = f["colors"] or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        f["offset"] = offset + 4 * f["colors"]
    if comp == 3:
        masks = f["masks"]
        if bits == 32 and masks in _MASKS32:
            if masks == (0, 0, 0, 0):
                masks = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
            f["masks"] = masks
            f["alpha"] = bool(masks[3])
        elif not ((bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF)) or
                  (bits == 16 and masks[:3] in ((0xF800, 0x7E0, 0x1F),
                                                (0x7C00, 0x3E0, 0x1F)))):
            raise BMPRefused("Unsupported BMP bitfields layout")
    elif comp in (1, 2):
        if bits > 8:
            # PIL's RLE decoder hands its indices to a "P" raw decoder,
            # which an RGB image refuses
            raise BMPError(f"RLE compression of a {bits}-bit BMP")
    elif comp != 0:
        raise BMPRefused(f"Unsupported BMP compression ({comp})")
    f["palette"] = None
    f["grey"] = False
    if bits <= 8:
        if not 0 < f["colors"] <= 65536:
            raise BMPRefused(f"Unsupported BMP Palette size ({f['colors']})")
        pal_pos = 14 + hsize
        pal = data[pal_pos:pal_pos + f["pad"] * f["colors"]]
        indices = (0, 255) if f["colors"] == 2 else range(f["colors"])
        grey = all(pal[k * f["pad"]:k * f["pad"] + 3] == bytes([v]) * 3
                   for k, v in enumerate(indices))
        f["grey"] = grey
        if comp in (1, 2) and grey and f["colors"] == 2:
            # PIL's "1" image takes no "P" raw mode
            raise BMPError("RLE compression of a black-and-white BMP")
        if not grey:
            t = np.frombuffer(pal[:len(pal) // f["pad"] * f["pad"]], np.uint8)
            f["palette"] = t.reshape(-1, f["pad"])[:256, 2::-1]
    return f


def bmp_layout(data: bytes):
    """(width, height, bands, dtype name) of the decoded image."""
    f = _parse(data)
    if f["bits"] <= 8:
        if f["grey"]:
            return (f["width"], f["height"], 1,
                    "bool" if f["colors"] == 2 else "uint8")
        return f["width"], f["height"], 3, "uint8"
    return f["width"], f["height"], 4 if f["alpha"] else 3, "uint8"


def _rle_indices(data: bytes, f: dict) -> np.ndarray:
    """(h, w) palette indices of an RLE8 or RLE4 bitmap, decoded as PIL's
    ``BmpRleDecoder`` decodes them, top row first."""
    w, h = f["width"], f["height"]
    rle4 = f["compression"] == 2
    pos = f["offset"]
    n = len(data)
    out = bytearray()
    x = 0
    need = w * h
    while len(out) < need:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            # encoded mode: a run, cut at the row's end
            count = max(0, w - x) if x + count > w else count
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += pair * (count // 2) + pair[:count % 2]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then moves by the
            if pos + 2 > n:  # next two
                break
            pos += 2
            if pos + 2 > n:
                raise BMPTruncated(
                    "not enough values to unpack (BMP RLE delta)")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # absolute mode
            if rle4:
                take = data[pos:pos + byte // 2]
                for b in take:
                    out += bytes([b >> 4, b & 15])
                short = len(take) < byte // 2
                pos += len(take)
            else:
                take = data[pos:pos + byte]
                out += take
                short = len(take) < byte
                pos += len(take)
            if short:
                break
            x += byte
            if pos % 2:  # word alignment, in the file's offsets
                pos += 1
    if len(out) < need:
        raise BMPNotEnoughData("not enough image data (BMP RLE)")
    rows = np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w)
    return rows if f["top_down"] else rows[::-1]


def decode_bmp_array(data: bytes) -> np.ndarray:
    """BMP bytes -> (H, W, B) array, as the JAX package decodes them."""
    f = _parse(data)
    w, h, bits = f["width"], f["height"], f["bits"]
    if not w or not h:
        raise BMPError("empty BMP image")
    if w * h > MAX_PIXELS:
        raise BMPError(f"image size ({w * h} pixels) exceeds the limit of "
                       f"{MAX_PIXELS} pixels (decompression bomb)")
    if f["compression"] in (1, 2):
        idx = _rle_indices(data, f)
        if f["grey"]:
            return np.ascontiguousarray(idx)[:, :, None]
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(f["palette"])] = f["palette"]
        return lut[idx]
    stride = ((w * bits + 31) >> 3) & ~3
    row_bytes = (w * bits + 7) // 8
    need = f["offset"] + (h - 1) * stride + row_bytes
    if need > len(data):
        raise BMPTruncated("image file is truncated (BMP pixel data)")
    raw = data[f["offset"]:f["offset"] + h * stride]
    raw += bytes(h * stride - len(raw))  # the last row's padding
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
    if not f["top_down"]:
        rows = rows[::-1]
    if bits <= 8:
        if bits == 8 or (bits == 4 and f["grey"]):
            # PIL reads a 4-bit grey-ramp BMP as 8-bit "L" rows, and
            # refuses rows shorter than the width
            if w > stride:
                raise BMPError("codec configuration error (4-bit grey BMP)")
            idx = rows[:, :w]
        else:
            per = 8 // bits
            unpacked = np.stack([(rows >> (8 - bits * (k + 1)))
                                 & ((1 << bits) - 1) for k in range(per)],
                                axis=2).reshape(h, -1)
            idx = unpacked[:, :w]
        if f["grey"]:
            if f["colors"] == 2:
                return idx.astype(bool)[:, :, None]
            return np.ascontiguousarray(idx)[:, :, None]
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(f["palette"])] = f["palette"]
        return lut[idx]
    if bits == 24:
        bgr = rows[:, :3 * w].reshape(h, w, 3)
        return np.ascontiguousarray(bgr[:, :, ::-1])
    if bits == 16:
        v = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
        if f["compression"] == 3 and f["masks"][0] == 0xF800:
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            gmax = 63
        else:
            r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
            gmax = 31
        return np.stack([r * 255 // 31, g * 255 // gmax, b * 255 // 31],
                        axis=2).astype(np.uint8)
    px = rows[:, :4 * w].reshape(h, w, 4)
    if f["compression"] == 3:
        masks = f["masks"]
        byte = [int(m).bit_length() // 8 - 1 if m else None for m in masks]
        chans = [byte[0], byte[1], byte[2]] + ([byte[3]] if f["alpha"]
                                               else [])
        return np.ascontiguousarray(px[:, :, chans])
    return np.ascontiguousarray(px[:, :, [2, 1, 0]])
