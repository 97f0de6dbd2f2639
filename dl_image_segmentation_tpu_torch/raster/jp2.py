"""JPEG 2000 (JP2/J2K): decode, encode, georeferencing, header sniff.

A copy of the JAX package's ``raster/jp2.py`` for the container walk
(``is_jp2``, ``_boxes``, ``_find_codestream``, the GeoJP2 and GMLJP2
parse, ``sniff_jp2_info``). Where the JAX package decodes and encodes
pixels through PIL's bundled OpenJPEG, the port has its own codec:
``csrc/host/j2k_decode.cc`` (a Part-1 decoder whose samples are
OpenJPEG 2.5's, bit for bit, for 5/3 and 9/7 files alike) and
``csrc/host/j2k_encode.cc`` (lossless 5/3), built with g++ into
``build/`` at first use and called through ctypes, which releases the
GIL for the call.

``decode_jp2`` returns what the JAX package returns: PIL's mode mapping
(``Jpeg2KImagePlugin``: one component above 8 bits is ``I;16``, 2 is
``LA``, 3 ``RGB``, 4 ``RGBA`` or ``CMYK`` by the ``colr`` box, a
``pclr`` box gives ``P``/``PA``), PIL's C unpackers (samples whose
precision is not the mode's 8 or 16 bits are shifted to it, with a
rounding offset when shifted down; signed samples are offset by
2^(prec-1)), then the JAX package's cast to the SIZ dtype. Where that
cast fails in the JAX package (numpy 2 refuses to clip PIL's array to a
dtype whose range it cannot hold: signed files, and RGB or LA of more
than 8 bits), the port returns the codestream's own samples in the SIZ
dtype instead; ROADMAP queue 3 logs the difference. Subsampled
components (XRsiz/YRsiz > 1) decode at their own extent and are spread
over the image grid as PIL's unpackers address OpenJPEG's tile buffer
(a tile's width over the subsampling, rounded down, as the row stride
and the component offset: odd extents come out skewed, as in PIL), and
sYCC files (``colr`` 18) go through PIL's ``ImagingConvertYCbCr2RGB``
tables, for 3 components and for 3 plus alpha. HTJ2K code-blocks raise
:class:`JP2Unsupported`, naming ROADMAP queue 1 item 6.
"""

from __future__ import annotations

import ctypes
import os
import re
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import _build
from .geotiff import GeoTIFF, RasterInfo, decode_geotiff_info
from .png import MAX_PIXELS

__all__ = ["JP2Error", "JP2Unsupported", "decode_jp2", "encode_jp2",
           "is_jp2", "palette_rgb", "sniff_jp2_info"]

_JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
_J2K_SOC = b"\xff\x4f\xff\x51"
# GeoJP2 UUID (GeoTIFF-in-JP2), universally used by GDAL
_GEOJP2_UUID = bytes.fromhex("b14bf8bd083d4b43a5ae8cd7d5a6ce03")

_HOST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host")
# no -ffast-math, no contraction: the 9/7 lifting must round as
# OpenJPEG's separate SSE multiplies and adds do
_CMD = ("g++", "-O3", "-shared", "-fPIC", "-ffp-contract=off")
_DEC_SIGNATURES = {
    "fc_j2k_info": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]),
    "fc_j2k_decode": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int]),
    "fc_j2k_decode_planes": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int]),
}
_ENC_SIGNATURES = {
    "fc_j2k_encode": (ctypes.c_int64, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64]),
}
_UNSUPPORTED = -3


class JP2Error(ValueError):
    """A JPEG 2000 file that does not parse or decode."""


class JP2Unsupported(JP2Error):
    """A JPEG 2000 file the port does not decode (PIL's unpackers would
    take it or it lies outside Part 1)."""


def _dec():
    return _build.load(_CMD, os.path.join(_HOST, "j2k_decode.cc"),
                       _DEC_SIGNATURES)


def _enc():
    return _build.load(_CMD, os.path.join(_HOST, "j2k_encode.cc"),
                       _ENC_SIGNATURES)


def _raise(rc: int, err) -> None:
    msg = err.raw.split(b"\0", 1)[0].decode("ascii", "replace")
    if rc == _UNSUPPORTED:
        if "HTJ2K" in msg:
            msg += ". HTJ2K code-blocks are ROADMAP queue 1 item 6"
        raise JP2Unsupported(f"unsupported JPEG 2000 feature: {msg}")
    raise JP2Error(msg or f"corrupt JPEG 2000 codestream ({rc})")


def is_jp2(data: bytes) -> bool:
    return data[:12] == _JP2_SIG or data[:4] == _J2K_SOC


def _boxes(data: bytes, start: int = 0, end: Optional[int] = None
           ) -> Iterator[Tuple[bytes, int, int]]:
    """Yield (box type, payload offset, payload length) over a JP2 box
    sequence (handles XL 64-bit and to-end-of-file lengths)."""
    i = start
    n = len(data) if end is None else end
    while i + 8 <= n:
        (ln,) = struct.unpack(">I", data[i:i + 4])
        typ = data[i + 4:i + 8]
        if ln == 1:
            if i + 16 > n:
                return
            (ln,) = struct.unpack(">Q", data[i + 8:i + 16])
            hdr = 16
        elif ln == 0:
            ln = n - i
            hdr = 8
        else:
            hdr = 8
        if ln < hdr:
            return
        yield typ, i + hdr, ln - hdr
        i += ln


def _find_codestream(data: bytes) -> Tuple[int, int]:
    """(offset, length) of the JPEG 2000 codestream."""
    if data[:4] == _J2K_SOC:
        return 0, len(data)
    for typ, off, ln in _boxes(data):
        if typ == b"jp2c":
            return off, ln
    raise ValueError("JP2 container has no codestream (jp2c) box")


def _parse_gml_geo(xml: str, info: RasterInfo) -> bool:
    """Best-effort GMLJP2 RectifiedGrid parse (the Sentinel-2
    convention). Returns True when a geotransform was extracted."""
    m = re.search(r"srsName=\"[^\"]*?(?:EPSG|epsg)[:#]+(\d+)", xml)
    if m:
        info.epsg = int(m.group(1))
    om = re.search(
        r"<gml:origin>.*?<gml:pos>([-\d.eE]+)\s+([-\d.eE]+)</gml:pos>",
        xml, re.S)
    vecs = re.findall(
        r"<gml:offsetVector[^>]*>([-\d.eE]+)\s+([-\d.eE]+)"
        r"</gml:offsetVector>", xml)
    if om and len(vecs) >= 2:
        ox, oy = float(om.group(1)), float(om.group(2))
        (a, b), (c, d) = (tuple(map(float, v)) for v in vecs[:2])
        # origin = upper-left pixel corner (S2 practice); first vector
        # steps columns, second steps rows
        info.geotransform = (ox, a, b, oy, c, d)
        return True
    return False


def _geo_from_boxes(data: bytes, info: RasterInfo) -> None:
    """Fill geotransform/EPSG from GeoJP2 or GMLJP2 boxes, if any."""
    if data[:4] == _J2K_SOC:
        return  # raw codestream: no boxes
    xml_payloads = []
    for typ, off, ln in _boxes(data):
        if typ == b"uuid" and ln > 16 \
                and data[off:off + 16] == _GEOJP2_UUID:
            try:
                geo = decode_geotiff_info(data[off + 16:off + ln])
            except Exception:  # noqa: BLE001 -- malformed geo box only
                continue
            info.geotransform = geo.geotransform
            info.epsg = geo.epsg
            info.wkt = geo.wkt
            if geo.nodata is not None:
                info.nodata = geo.nodata
            return
        if typ in (b"xml ", b"asoc"):
            xml_payloads.append(data[off:off + ln])
    for payload in xml_payloads:
        xml = payload.decode("utf-8", "ignore")
        if "RectifiedGrid" in xml and _parse_gml_geo(xml, info):
            from ..geo import crs as _crs
            if info.epsg and 32601 <= info.epsg <= 32660:
                info.wkt = _crs.utm_wkt(info.epsg - 32600, north=True)
            elif info.epsg and 32701 <= info.epsg <= 32760:
                info.wkt = _crs.utm_wkt(info.epsg - 32700, north=False)
            return


def sniff_jp2_info(data: bytes) -> RasterInfo:
    """Shape/bands/dtype (+geo) from headers only: the codestream SIZ
    segment, no pixel decode."""
    off, ln = _find_codestream(data)
    cs = data[off:off + ln]
    if cs[:4] != _J2K_SOC:
        raise ValueError("corrupt JPEG 2000 codestream (no SOC+SIZ)")
    # after SOC(2) + SIZ marker(2): Lsiz(2) Rsiz(2) Xsiz(4) Ysiz(4)
    # XOsiz(4) YOsiz(4) XTsiz(4) YTsiz(4) XTOsiz(4) YTOsiz(4) Csiz(2)
    (xsiz, ysiz, xo, yo) = struct.unpack(">IIII", cs[8:24])
    (csiz,) = struct.unpack(">H", cs[40:42])
    ssiz = cs[42]  # first component
    depth = (ssiz & 0x7F) + 1
    signed = bool(ssiz & 0x80)
    if depth <= 8:
        dtype = "int8" if signed else "uint8"
    elif depth <= 16:
        dtype = "int16" if signed else "uint16"
    else:
        dtype = "int32" if signed else "uint32"
    info = RasterInfo(width=xsiz - xo, height=ysiz - yo, count=csiz,
                      dtype=dtype)
    _geo_from_boxes(data, info)
    return info


# OpenJPEG's colour spaces, as PIL's decoder sees them
_UNSPECIFIED, _SRGB, _GRAY, _SYCC, _CMYK, _UNKNOWN = range(6)
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 12: _CMYK}

# PIL's unpackers (Jpeg2KDecode.c j2k_unpackers): (mode, colour space,
# components) -> the bit width each component is shifted to
_UNPACKERS = {
    ("L", _GRAY, 1): 8, ("P", _SRGB, 1): 8, ("PA", _SRGB, 2): 8,
    ("I;16", _GRAY, 1): 16, ("LA", _GRAY, 2): 8, ("RGB", _SRGB, 3): 8,
    ("RGBA", _SRGB, 4): 8, ("CMYK", _CMYK, 4): 8, ("RGB", _SYCC, 3): 8,
    ("RGBA", _SYCC, 4): 8,
}
# the unpackers that take subsampled components
_SUBSAMPLED = {("RGB", _SRGB, 3), ("RGB", _SYCC, 3), ("RGBA", _SRGB, 4),
               ("RGBA", _SYCC, 4), ("CMYK", _CMYK, 4)}


def _ycc_table(c: float) -> np.ndarray:
    # ConvertYCbCr.c's tables: (int)(c * 64 * (i - 128) + 0.5)
    return np.trunc(c * 64 * (np.arange(256) - 128) + 0.5).astype(np.int32)


_R_CR, _G_CB, _G_CR, _B_CB = (_ycc_table(c) for c in (1.402, -0.34414,
                                                      -0.71414, 1.772))


def _ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """PIL's ``ImagingConvertYCbCr2RGB`` on the first three uint8
    channels; any fourth (alpha) passes through."""
    y, cb, cr = (ycc[:, :, k].astype(np.int32) for k in range(3))
    out = ycc.copy()
    out[:, :, 0] = np.clip(y + (_R_CR[cr] >> 6), 0, 255)
    out[:, :, 1] = np.clip(y + ((_G_CB[cb] + _G_CR[cr]) >> 6), 0, 255)
    out[:, :, 2] = np.clip(y + (_B_CB[cb] >> 6), 0, 255)
    return out


def _pil_mode(data: bytes, csiz: int, prec0: int
              ) -> Tuple[str, int, Optional[bytes]]:
    """(PIL mode, OpenJPEG colour space, the body of the pclr box that
    made the mode P or PA, else None) of a JP2/J2K file, as
    ``Jpeg2KImagePlugin`` and OpenJPEG's box reader give them."""
    if data[:4] == _J2K_SOC:
        if csiz == 1:
            mode = "I;16" if prec0 > 8 else "L"
        else:
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(csiz)
        if mode is None:
            raise JP2Unsupported(f"JPEG 2000 codestream of {csiz} "
                                 "components: PIL maps 1 to 4")
        return mode, _UNSPECIFIED, None
    jp2h = next(((off, ln) for typ, off, ln in _boxes(data, 12)
                 if typ == b"jp2h"), None)
    if jp2h is None:
        raise JP2Error("JP2 file without a jp2h header box")
    mode = None
    nc = None
    space = None
    pclr = None
    for typ, off, ln in _boxes(data, jp2h[0], jp2h[0] + jp2h[1]):
        body = data[off:off + ln]
        if typ == b"ihdr":
            if len(body) < 11:
                raise JP2Error("short ihdr box")
            _, _, nc, bpc = struct.unpack(">IIHB", body[:11])
            if nc == 1:
                mode = "I;16" if (bpc & 0x7F) > 8 else "L"
            else:
                mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(nc)
        elif typ == b"colr" and len(body) >= 3:
            meth = body[0]
            enumcs = struct.unpack(">I", body[3:7])[0] \
                if meth == 1 and len(body) >= 7 else None
            if nc == 4 and meth == 1 and enumcs == 12:
                mode = "CMYK"
            if space is None:  # OpenJPEG takes the first colr box
                space = _ENUMCS.get(enumcs, _UNKNOWN)
        elif typ == b"pclr" and mode in ("L", "LA") and len(body) >= 3:
            ne, npc = struct.unpack(">HB", body[:3])
            depths = body[3:3 + npc]
            if max(depths, default=0) <= 8:
                mode = "P" if mode == "L" else "PA"
                pclr = body
    if mode is None:
        raise JP2Error("malformed JP2 header")
    return mode, _UNKNOWN if space is None else space, \
        pclr if mode in ("P", "PA") else None


def palette_rgb(data: bytes) -> Optional[np.ndarray]:
    """The (256, 3) uint8 table through which PIL's ``convert("RGB")``
    shows a JP2 of mode P, or None for any other file. PIL reads the
    pclr box's entries through ``ImagePalette.getcolor``: an entry equal
    to an earlier one is dropped (the entries after it move up), 3
    components make an RGB palette and 4 an RGBA one, and indices past
    the palette are black."""
    if not is_jp2(data) or data[:4] == _J2K_SOC:
        return None
    off, ln = _find_codestream(data)
    w, h, comps = _codestream_info(bytes(data[off:off + ln]))
    mode, _, pclr = _pil_mode(data, len(comps), comps[0][0])
    if mode != "P":
        return None
    ne, npc = struct.unpack(">HB", pclr[:3])
    if len(pclr) < 3 + npc + ne * npc:
        raise JP2Error("short pclr box")
    width = 4 if npc == 4 else 3  # PIL's palette mode: RGBA or RGB
    palette, seen = bytearray(), set()
    for i in range(ne):
        color = pclr[3 + npc + i * npc:3 + npc + (i + 1) * npc]
        if color in seen:
            continue
        seen.add(color)
        index = len(palette) // width
        if index >= 256:
            raise JP2Error("JP2 palette of more than 256 colours (PIL: "
                           "cannot allocate more than 256 colors)")
        if index * width < len(palette):
            palette[index * width:index * width + width] = color
        else:
            palette += color
    table = np.zeros((256, 3), np.uint8)
    k = len(palette) // width
    table[:k] = np.frombuffer(bytes(palette[:k * width]), np.uint8).reshape(
        k, width)[:, :3]
    return table


def _codestream_info(cs: bytes):
    info = np.zeros(3 + 4 * 4, np.int64)
    err = ctypes.create_string_buffer(256)
    rc = _dec().fc_j2k_info(cs, len(cs), info.ctypes.data, info.size,
                            err, 256)
    if rc:
        _raise(rc, err)
    w, h, nc = (int(v) for v in info[:3])
    comps = [tuple(int(v) for v in info[3 + 4 * i:7 + 4 * i])
             for i in range(nc)]
    return w, h, comps


def _decode_codestream(cs: bytes, w: int, h: int, comps) -> np.ndarray:
    """(H, W, C) samples, clamped to each component's range, in the
    narrowest integer type that holds every component."""
    es = max((p + 7) // 8 for p, _, _, _ in comps)
    es = 4 if es == 3 else es
    signed = any(s for _, s, _, _ in comps)
    dtype = np.dtype(f"{'i' if signed else 'u'}{es}")
    out = np.empty((h, w, len(comps)), dtype)
    err = ctypes.create_string_buffer(256)
    rc = _dec().fc_j2k_decode(cs, len(cs), out.ctypes.data, es, out.size,
                              err, 256)
    if rc:
        _raise(rc, err)
    return out


def _decode_as_pil_addresses(cs: bytes, w: int, h: int,
                              comps) -> np.ndarray:
    """(H, W, C) samples of a file with subsampled components, each read
    where PIL's Jpeg2KDecode.c unpackers read it. Per tile (in raster
    order), OpenJPEG writes each component's tile plane at its own extent
    into PIL's tile buffer, one after the other, in (prec + 7) // 8 bytes
    a sample (4 for 3); the unpacker reads component n of pixel (x, y) of
    a tile tw x th at byte sum_m csiz_m (tw / dx_m) (th / dy_m) + csiz_n
    ((y / dy) (tw / dx) + x / dx), the divisions rounded down. Where that
    runs past the tile's data it reads zeros: PIL zeroes the buffer, which
    keeps the size of the largest tile so far. (Past that size PIL would
    read other memory; the port repeats the buffer's last byte.)"""
    csiz = [4 if (p + 7) // 8 == 3 else (p + 7) // 8 for p, _, _, _ in comps]
    es = max(csiz)
    signed = any(s for _, s, _, _ in comps)
    dtype = np.dtype(f"{'i' if signed else 'u'}{es}")
    (xsiz, ysiz, x0, y0, xt, yt, xt0, yt0) = struct.unpack(
        ">8I", cs[8:40])
    extents = [(-(-xsiz // dx) - -(-x0 // dx), -(-ysiz // dy) - -(-y0 // dy))
               for _, _, dx, dy in comps]
    flat = np.empty(sum(a * b for a, b in extents), dtype)
    err = ctypes.create_string_buffer(256)
    rc = _dec().fc_j2k_decode_planes(cs, len(cs), flat.ctypes.data, es,
                                     flat.size, err, 256)
    if rc:
        _raise(rc, err)
    planes, k = [], 0
    for cw, ch in extents:
        planes.append(flat[k:k + cw * ch].reshape(ch, cw))
        k += cw * ch
    out = np.zeros((h, w, len(comps)), np.uint32)
    pbuf = np.zeros(0, np.uint8)
    for q in range(-(-(ysiz - yt0) // yt)):
        gy0, gy1 = max(yt0 + q * yt, y0), min(yt0 + (q + 1) * yt, ysiz)
        for p in range(-(-(xsiz - xt0) // xt)):
            gx0, gx1 = max(xt0 + p * xt, x0), min(xt0 + (p + 1) * xt, xsiz)
            tw, th = gx1 - gx0, gy1 - gy0
            parts = []
            for n, ((_, _, dx, dy), plane) in enumerate(zip(comps, planes)):
                ox, oy = -(-x0 // dx), -(-y0 // dy)
                tile = plane[-(-gy0 // dy) - oy:-(-gy1 // dy) - oy,
                             -(-gx0 // dx) - ox:-(-gx1 // dx) - ox]
                parts.append(tile.astype(f"<u{csiz[n]}").view(
                    np.uint8).ravel())
            data = np.concatenate(parts)
            pbuf = np.zeros(max(data.size, pbuf.size), np.uint8)
            pbuf[:data.size] = data
            yy, xx = np.mgrid[0:th, 0:tw]
            off = 0
            for n, (_, _, dx, dy) in enumerate(comps):
                at = off + csiz[n] * ((yy // dy) * (tw // dx) + xx // dx)
                word = np.zeros(at.shape, np.uint32)
                for b in range(csiz[n]):
                    word |= pbuf[np.minimum(at + b, pbuf.size - 1)].astype(
                        np.uint32) << (8 * b)
                out[gy0 - y0:gy1 - y0, gx0 - x0:gx1 - x0, n] = word
                off += csiz[n] * (tw // dx) * (th // dy)
    return out.astype(dtype)


def _unpack(samples: np.ndarray, comps, bits: int) -> np.ndarray:
    """PIL's j2ku_* unpackers: each component read as unsigned in its
    (prec + 7) // 8 bytes, offset (signed: 2^(prec-1); shifted down: a
    rounding half), shifted to ``bits`` and truncated to it."""
    out = np.empty(samples.shape, np.uint16 if bits == 16 else np.uint8)
    for n, (prec, sgnd, _, _) in enumerate(comps):
        csiz = (prec + 7) >> 3
        csiz = 4 if csiz == 3 else csiz
        word = samples[:, :, n].astype(np.int64) & ((1 << (8 * csiz)) - 1)
        shift = bits - prec
        offset = (1 << (prec - 1)) if sgnd else 0
        if shift < 0:
            offset += 1 << (-shift - 1)
        v = (word + offset) & 0xFFFFFFFF
        v = (v << shift) & 0xFFFFFFFF if shift >= 0 else v >> -shift
        out[:, :, n] = v
    return out


def decode_jp2(data: bytes) -> GeoTIFF:
    """JP2/J2K bytes -> GeoTIFF-like (array bands-last, RasterInfo with
    geo tags when the container carries GeoJP2/GMLJP2)."""
    off, ln = _find_codestream(data)
    cs = bytes(data[off:off + ln])
    w, h, comps = _codestream_info(cs)
    if w * h > MAX_PIXELS:
        raise JP2Error(f"image size ({w * h} pixels) exceeds the limit of "
                       f"{MAX_PIXELS} pixels (decompression bomb)")
    mode, space, _ = _pil_mode(data, len(comps), comps[0][0])
    sub = [dx != 1 or dy != 1 for _, _, dx, dy in comps]
    if space == _UNSPECIFIED:
        # Jpeg2KDecode.c: a codestream without a colour space whose first
        # subsampled component is the second or third is sYCC
        first = sub.index(True) if any(sub) else -1
        space = (_GRAY if len(comps) <= 2 else
                 _SYCC if first in (1, 2) else _SRGB)
    subsampled = any(sub)
    bits = _UNPACKERS.get((mode, space, len(comps)))
    if bits is None or (subsampled and
                        (mode, space, len(comps)) not in _SUBSAMPLED):
        raise JP2Error(f"no decoder for a {len(comps)}-component JPEG 2000 "
                       f"file of mode {mode}"
                       f"{' with subsampling' if subsampled else ''} "
                       "(PIL: broken data stream)")
    if subsampled:
        samples = _decode_as_pil_addresses(cs, w, h, comps)
    else:
        samples = _decode_codestream(cs, w, h, comps)
    sniff = sniff_jp2_info(data)
    want = np.dtype(sniff.dtype)
    prec, sgnd = comps[0][0], comps[0][1]
    if prec == bits and not sgnd and all(c[:2] == (prec, 0) for c in comps):
        arr = samples.astype(want, copy=False)  # PIL's unpack is the identity
    else:
        arr = _unpack(samples, comps, bits)
        if arr.dtype != want:
            # the JAX package's np.clip to the SIZ dtype raises here:
            # return the codestream's samples
            arr = samples.astype(want)
    if space == _SYCC and arr.dtype == np.uint8:
        arr = _ycbcr_to_rgb(arr)
    info = RasterInfo(width=w, height=h, count=arr.shape[2],
                      dtype=arr.dtype.name, geotransform=sniff.geotransform,
                      epsg=sniff.epsg, wkt=sniff.wkt, nodata=sniff.nodata)
    return GeoTIFF(np.ascontiguousarray(arr), info)


def _boxed(cs: bytes, h: int, w: int, nc: int, prec: int) -> bytes:
    """A JP2 file around a codestream: signature, ftyp, jp2h (ihdr,
    colr), jp2c -- the boxes OpenJPEG writes for PIL."""
    def box(typ: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", 8 + len(payload)) + typ + payload
    ihdr = struct.pack(">IIHBBBB", h, w, nc, prec - 1, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, 17 if nc <= 2 else 16)
    return (_JP2_SIG + box(b"ftyp", b"jp2 " + b"\0\0\0\0" + b"jp2 ")
            + box(b"jp2h", box(b"ihdr", ihdr) + box(b"colr", colr))
            + box(b"jp2c", cs))


def encode_jp2(array: np.ndarray,
               geotransform: Optional[Tuple[float, ...]] = None,
               epsg: Optional[int] = None,
               nodata: Optional[float] = None) -> bytes:
    """Encode an array as lossless (reversible 5/3) JP2; geo metadata
    is embedded as a GeoJP2 UUID box (a degenerate 1x1 GeoTIFF built
    with the port's own encoder). uint8 takes 1-4 bands, uint16 one band."""
    arr = np.asarray(array)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    if arr.dtype == np.uint16:
        if arr.ndim != 2:
            raise ValueError("uint16 JP2 encode is single-band "
                             "(the Sentinel-2 profile)")
        prec = 16
    elif arr.dtype == np.uint8:
        prec = 8
    else:
        raise ValueError(f"JP2 encoding takes uint8 or uint16, not "
                         f"{arr.dtype.name}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, nc = arr.shape
    if nc > 4 or h == 0 or w == 0:
        raise ValueError(f"cannot encode an array of shape {arr.shape} "
                         "as JP2")
    arr = np.ascontiguousarray(arr)
    # lossless worst case: every bit-plane of every sample plus the
    # packet headers and markers
    cap = 4096 + int(h) * int(w) * nc * (prec // 8 + 1) * 2
    out = np.empty(cap, np.uint8)
    # options 0: PIL's parameters (no colour transform, mct=0)
    n = _enc().fc_j2k_encode(arr.ctypes.data, h, w, nc, prec, 0,
                             out.ctypes.data, cap)
    if n < 0:
        raise ValueError(f"JP2 encoding failed ({n})")
    data = _boxed(out[:n].tobytes(), h, w, nc, prec)
    if geotransform is None and epsg is None:
        return data
    from .geotiff import encode_geotiff
    degenerate = encode_geotiff(np.zeros((1, 1), np.uint8),
                                geotransform=geotransform, epsg=epsg,
                                nodata=nodata, compress="none",
                                tiled=False)
    payload = _GEOJP2_UUID + degenerate
    box = struct.pack(">I", 8 + len(payload)) + b"uuid" + payload
    # before the codestream box, as the JAX package inserts it
    off, _ = _find_codestream(data)
    return data[:off - 8] + box + data[off - 8:]
