"""GIF first-frame decoder of the port (no PIL).

Returns what the JAX package's decode (PIL's first frame, palette images
expanded to RGB) returns:

* the canvas is the logical screen, grown to hold the first frame's
  extent; pixels outside the frame hold the frame's transparent index
  (when its graphic control extension names one), else index 0;
* the frame's colour table is its local table, else the global one; a
  table that is the identity grey ramp (entry i = (i, i, i)) is no
  palette, and the frame decodes to 1 band of indices; otherwise it
  decodes to 3 bands of RGB, an index past the table's end being black;
* interlaced frames are reordered (rows 0, 4, 2, 1 modulo 8, 8, 4, 2).

The variable-width LZW stream is decoded in C++
(``csrc/host/lzw.cc:fc_gif_lzw_decode``). A frame whose data ends before
its last pixel and before an end code raises :class:`GIFError`
("truncated"); after an end code the rest of the frame keeps index 0.
"""

from __future__ import annotations

import struct

import numpy as np

from .codec_errors import TruncatedData
from .lzw import gif_lzw_decode_native
from .png import MAX_PIXELS

__all__ = ["GIFError", "decode_gif_array", "gif_layout"]


class GIFError(ValueError):
    """A GIF that does not parse or decode."""


class GIFTruncated(GIFError, TruncatedData):
    """A GIF whose colour table or image data ends early."""


def _is_identity_ramp(table: bytes) -> bool:
    t = np.frombuffer(table, np.uint8).reshape(-1, 3)
    return bool((t == np.arange(len(t))[:, None]).all())


def _table(data: bytes, pos: int, flags: int):
    """(colour table or None, next position) after a descriptor."""
    if not flags & 0x80:
        return None, pos
    size = 3 << ((flags & 7) + 1)
    if pos + size > len(data):
        raise GIFTruncated("image file is truncated (colour table)")
    return data[pos:pos + size], pos + size


def _sub_blocks(data: bytes, pos: int):
    """(joined sub-block bytes, position after the terminator or the end
    of the data)."""
    parts = []
    n = len(data)
    while pos < n:
        size = data[pos]
        pos += 1
        if size == 0:
            break
        parts.append(data[pos:pos + size])
        pos += size
    return b"".join(parts), min(pos, n)


def _first_frame(data: bytes):
    """Screen size, the frame's descriptor fields and the positions of
    its tables and image data."""
    if len(data) < 13 or data[:4] != b"GIF8":
        raise GIFError("not a GIF file")
    sw, sh, flags = struct.unpack("<HHB", data[6:11])
    gtable, pos = _table(data, 13, flags)
    transparency = None
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        if tag == 0x21:  # extension
            if pos >= n:
                break
            label = data[pos]
            block, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(block) >= 4 and block[0] & 1:
                transparency = block[3]
        elif tag == 0x2C:  # image descriptor
            if pos + 9 > n:
                break
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", data[pos:pos + 9])
            ltable, pos = _table(data, pos + 9, fflags)
            if pos >= n:
                break
            return dict(screen=(sw, sh), box=(x0, y0, fw, fh),
                        interlace=bool(fflags & 0x40), gtable=gtable,
                        ltable=ltable, transparency=transparency,
                        min_size=data[pos], data_pos=pos + 1)
        elif tag == 0x3B:  # trailer
            break
        else:
            raise GIFError(f"corrupt GIF block 0x{tag:02x}")
    raise GIFTruncated("image not found in GIF frame (truncated?)")


def _palette(f):
    """The frame's palette, or None for a 1-band (identity grey) frame."""
    if f["ltable"] is not None:
        return None if _is_identity_ramp(f["ltable"]) else f["ltable"]
    g = f["gtable"]
    return None if g is None or _is_identity_ramp(g) else g


def gif_layout(data: bytes):
    """(width, height, bands) of the decoded first frame."""
    f = _first_frame(data)
    x0, y0, fw, fh = f["box"]
    sw, sh = f["screen"]
    return (max(sw, x0 + fw), max(sh, y0 + fh),
            1 if _palette(f) is None else 3)


def decode_gif_array(data: bytes) -> np.ndarray:
    """GIF bytes -> the first frame, (H, W, 1) indices or (H, W, 3) RGB."""
    f = _first_frame(data)
    x0, y0, fw, fh = f["box"]
    sw, sh = f["screen"]
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    if w * h > MAX_PIXELS:
        raise GIFError(f"image size ({w * h} pixels) exceeds the limit of "
                       f"{MAX_PIXELS} pixels (decompression bomb)")
    if not w or not h:
        raise GIFError("empty GIF image")
    canvas = np.full((h, w), f["transparency"] or 0, np.uint8)
    npix = fw * fh
    if npix:
        stream, _ = _sub_blocks(data, f["data_pos"])
        idx, got, ended = gif_lzw_decode_native(stream, f["min_size"], npix)
        if got < npix and not ended:
            raise GIFTruncated(f"image file is truncated ({got} of {npix} "
                           "pixels)")
        frame = idx.reshape(fh, fw)
        if f["interlace"]:
            order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                    np.arange(2, fh, 4), np.arange(1, fh, 2)])
            frame = frame[np.argsort(order, kind="stable")]
        canvas[y0:y0 + fh, x0:x0 + fw] = frame
    pal = _palette(f)
    if pal is None:
        return canvas[:, :, None]
    lut = np.zeros((256, 3), np.uint8)
    table = np.frombuffer(pal, np.uint8).reshape(-1, 3)
    lut[:len(table)] = table
    return lut[canvas]
