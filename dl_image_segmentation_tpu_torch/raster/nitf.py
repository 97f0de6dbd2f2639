"""NITF 2.1 raster decoder and encoder.

A copy of the JAX package's ``raster/nitf.py``, the mainstream subset of
MIL-STD-2500C:

* NITF02.10 file headers (fixed-width ASCII fields; the FL/HL/NUMI
  segment table addresses each image segment);
* image subheaders: INT/SI/R pixel types at 8/16/32 bits, IMODE B
  (band-interleaved-by-block), P (pixel-interleaved) and S (band
  sequential), multi-block grids with edge clipping, band counts up
  to XBANDS;
* IC=NC (uncompressed), and IC=C8 (JPEG 2000) for single-block images
  through the port's own JPEG 2000 codec (``raster/jp2.py``);
* georeferencing from ICORDS=D (decimal-degree corners -> EPSG:4326)
  and ICORDS=N/S (UTM zone + easting + northing corners -> EPSG:326xx/
  327xx), as a geotransform when the corner quad is axis-aligned.

Two faults of the JAX package are not carried: the output raster is
capped at 65,536 rows and columns before it is allocated, and
``encode_nitf`` writes NPPBH/NPPBV 0000 (one block the size of the
image) where a block is wider than 9,999 pixels, where the JAX package
writes 9999. ``sniff_nitf_info`` reports what the decode returns, or
raises what it raises.

Everything else (masked IC=NM/M8, C3 JPEG, LUTs, images after the
first) raises.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .geotiff import GeoTIFF, RasterInfo
from .jp2 import decode_jp2, encode_jp2, sniff_jp2_info

__all__ = ["is_nitf", "decode_nitf", "sniff_nitf_info", "encode_nitf"]

# offsets of the fixed fields this decoder needs, derived from the
# MIL-STD-2500C NITF 2.1 field widths (file header: FHDR..ONAME/OPHONE
# sum to 342 bytes before FL)
_FL_OFF = 342          # FL (12) file length
_HL_OFF = 354          # HL (6) file header length
_NUMI_OFF = 360        # NUMI (3), then per image LISH (6) + LI (10)

# image subheader: IM..ISORCE sum to 333 bytes before NROWS
_NROWS_OFF = 333       # NROWS (8), NCOLS (8), PVTYPE (3), IREP (8),
                       # ICAT (8), ABPP (2), PJUST (1), ICORDS (1)

_MAX_SIDE = 1 << 16    # decode cap on rows and columns, as gpkg_raster's


def is_nitf(data: bytes) -> bool:
    return data[:9] == b"NITF02.10" or data[:9] == b"NITF02.00"


def _ascii_int(data: bytes, off: int, width: int, what: str) -> int:
    field = data[off:off + width]
    if len(field) != width:
        raise ValueError(f"NITF truncated at {what}")
    try:
        return int(field)
    except ValueError:
        raise ValueError(f"NITF bad numeric field {what}: {field!r}")


class _Sub:
    """Parsed image subheader + where its data starts."""

    __slots__ = ("nrows", "ncols", "dtype", "nbands", "imode", "ic",
                 "nbpr", "nbpc", "nppbh", "nppbv", "nbpp",
                 "geotransform", "epsg", "data_off")


def _parse_corners(icords: str, igeolo: bytes, nrows: int, ncols: int
                   ) -> Tuple[Optional[Tuple[float, ...]], Optional[int]]:
    """(geotransform, epsg) from the 4x15-char corner field (UL, UR,
    LR, LL order per spec). None when unsupported/rotated."""
    try:
        if icords == "D":
            # +-dd.ddd+-ddd.ddd per corner (lat then lon)
            cs = []
            for k in range(4):
                f = igeolo[k * 15:(k + 1) * 15].decode("ascii")
                cs.append((float(f[:7]), float(f[7:])))  # (lat, lon)
            epsg = 4326
            pts = [(lon, lat) for lat, lon in cs]
        elif icords in ("N", "S"):
            # zzeeeeeennnnnnn per corner (UTM zone, easting, northing)
            cs = []
            zone = None
            for k in range(4):
                f = igeolo[k * 15:(k + 1) * 15].decode("ascii")
                z = int(f[:2])
                zone = z if zone is None else zone
                if z != zone:
                    return None, None  # corner quad crosses zones
                cs.append((float(f[2:8]), float(f[8:15])))
            epsg = (32600 if icords == "N" else 32700) + zone
            pts = cs  # (easting, northing)
        else:
            return None, None
    except (ValueError, UnicodeDecodeError):
        return None, None
    (ulx, uly), (urx, ury), (lrx, lry), (llx, lly) = pts
    # axis-aligned (within a pixel's tolerance): UL/UR share y,
    # UL/LL share x
    px = (urx - ulx) / ncols
    py = (lly - uly) / nrows
    if px == 0 or py == 0:
        return None, None
    tol = max(abs(px), abs(py)) * 1.5
    if abs(ury - uly) > tol or abs(llx - ulx) > tol:
        return None, None  # rotated: keep pixels, drop geo
    return (ulx, px, 0.0, uly, 0.0, py), epsg


def _parse_subheader(data: bytes, off: int) -> _Sub:
    d = data[off:]
    if d[:2] != b"IM":
        raise ValueError("NITF image subheader does not start with IM")
    s = _Sub()
    s.nrows = _ascii_int(d, _NROWS_OFF, 8, "NROWS")
    s.ncols = _ascii_int(d, _NROWS_OFF + 8, 8, "NCOLS")
    pvtype = d[_NROWS_OFF + 16:_NROWS_OFF + 19].decode(
        "ascii", "replace").strip()
    p = _NROWS_OFF + 19 + 8 + 8 + 2 + 1  # skip IREP, ICAT, ABPP, PJUST
    icords = d[p:p + 1].decode("ascii", "replace")
    p += 1
    s.geotransform = None
    s.epsg = None
    if icords.strip():
        igeolo = d[p:p + 60]
        p += 60
        gt, epsg = _parse_corners(icords, igeolo, s.nrows, s.ncols)
        s.geotransform, s.epsg = gt, epsg
    nicom = _ascii_int(d, p, 1, "NICOM")
    p += 1 + nicom * 80
    s.ic = d[p:p + 2].decode("ascii", "replace")
    p += 2
    if s.ic not in ("NC", "NM"):
        p += 4  # COMRAT
    nbands = _ascii_int(d, p, 1, "NBANDS")
    p += 1
    if nbands == 0:
        nbands = _ascii_int(d, p, 5, "XBANDS")
        p += 5
    s.nbands = nbands
    for _ in range(nbands):
        p += 2 + 6 + 1 + 3  # IREPBANDn, ISUBCATn, IFCn, IMFLTn
        nluts = _ascii_int(d, p, 1, "NLUTS")
        p += 1
        if nluts > 0:
            raise ValueError("NITF band LUTs are not supported")
    p += 1  # ISYNC
    s.imode = d[p:p + 1].decode("ascii", "replace")
    p += 1
    s.nbpr = _ascii_int(d, p, 4, "NBPR")
    s.nbpc = _ascii_int(d, p + 4, 4, "NBPC")
    s.nppbh = _ascii_int(d, p + 8, 4, "NPPBH")
    s.nppbv = _ascii_int(d, p + 12, 4, "NPPBV")
    s.nbpp = _ascii_int(d, p + 16, 2, "NBPP")
    p += 18
    p += 3 + 3 + 10 + 4  # IDLVL, IALVL, ILOC, IMAG
    udidl = _ascii_int(d, p, 5, "UDIDL")
    p += 5 + (udidl if udidl else 0)
    ixshdl = _ascii_int(d, p, 5, "IXSHDL")
    p += 5 + (ixshdl if ixshdl else 0)
    s.data_off = off + p

    if pvtype == "INT":
        kinds = {8: "uint8", 16: "uint16", 32: "uint32"}
    elif pvtype == "SI":
        kinds = {8: "int8", 16: "int16", 32: "int32"}
    elif pvtype == "R":
        kinds = {32: "float32", 64: "float64"}
    else:
        raise ValueError(f"NITF pixel type {pvtype!r} not supported")
    if s.nbpp not in kinds:
        raise ValueError(f"NITF {pvtype} at {s.nbpp} bpp not supported")
    s.dtype = kinds[s.nbpp]
    if s.nppbh <= 0 or s.nppbv <= 0:
        # un-blocked convention: 0000 means the whole image is one
        # block
        s.nppbh = s.ncols
        s.nppbv = s.nrows
    return s


def _segments(data: bytes) -> List[Tuple[int, int, int]]:
    """[(subheader_off, subheader_len, data_len)] for each image
    segment, from the file-header segment table."""
    if not is_nitf(data):
        raise ValueError("not a NITF file")
    hl = _ascii_int(data, _HL_OFF, 6, "HL")
    numi = _ascii_int(data, _NUMI_OFF, 3, "NUMI")
    segs = []
    off = hl
    for k in range(numi):
        lish = _ascii_int(data, _NUMI_OFF + 3 + k * 16, 6, "LISH")
        li = _ascii_int(data, _NUMI_OFF + 9 + k * 16, 10, "LI")
        segs.append((off, lish, li))
        off += lish + li
    if not segs:
        raise ValueError("NITF file has no image segments")
    return segs


def _check_decodable(s: _Sub) -> None:
    """Raise what ``decode_nitf`` raises for the subheader alone."""
    if s.ic == "C8":
        if s.nbpr * s.nbpc != 1:
            raise ValueError("NITF C8 with multiple blocks is not "
                             "supported")
        return
    if s.ic != "NC":
        raise ValueError(f"NITF compression {s.ic!r} is not supported "
                         "(NC and single-block C8 are)")
    if s.nrows > _MAX_SIDE or s.ncols > _MAX_SIDE:
        # the header's 8-digit fields are untrusted: refuse before the
        # allocation (the JAX package allocates whatever they say)
        raise ValueError(f"NITF image too large ({s.ncols} x {s.nrows})")


def sniff_nitf_info(data: bytes) -> RasterInfo:
    """Shape/dtype/geo of the FIRST image segment from headers only: what
    ``decode_nitf`` returns (a C8 image's codestream header gives its
    shape and dtype, and its georeferencing where the subheader has
    none), or its error. The JAX package reports the subheader's fields
    whatever its decode does."""
    off, lish, li = _segments(data)[0]
    s = _parse_subheader(data, off)
    _check_decodable(s)
    if s.ic == "C8":
        j = sniff_jp2_info(data[s.data_off:off + lish + li])
        return RasterInfo(width=j.width, height=j.height, count=j.count,
                          dtype=j.dtype,
                          geotransform=s.geotransform or j.geotransform,
                          epsg=s.epsg or j.epsg)
    return RasterInfo(width=s.ncols, height=s.nrows, count=s.nbands,
                      dtype=s.dtype, geotransform=s.geotransform,
                      epsg=s.epsg)


def decode_nitf(data: bytes) -> GeoTIFF:
    """First image segment -> (H, W, B) bands-last array."""
    off, lish, li = _segments(data)[0]
    s = _parse_subheader(data, off)
    seg = data[s.data_off:off + lish + li]
    _check_decodable(s)
    if s.ic == "C8":
        g = decode_jp2(seg)
        info = RasterInfo(width=g.array.shape[1],
                          height=g.array.shape[0],
                          count=g.array.shape[2],
                          dtype=g.array.dtype.name,
                          geotransform=s.geotransform or
                          g.info.geotransform,
                          epsg=s.epsg or g.info.epsg)
        return GeoTIFF(g.array, info)
    dt = np.dtype(s.dtype).newbyteorder(">")  # NITF data is big-endian
    bpp = dt.itemsize
    block = s.nppbv * s.nppbh
    out = np.zeros((s.nrows, s.ncols, s.nbands), np.dtype(s.dtype))

    def need(n):
        if len(seg) < n:
            raise ValueError("NITF image data truncated")

    if s.imode in ("B", "P"):
        pos = 0
        for br in range(s.nbpc):
            for bc in range(s.nbpr):
                r0, c0 = br * s.nppbv, bc * s.nppbh
                vr = min(s.nppbv, s.nrows - r0)
                vc = min(s.nppbh, s.ncols - c0)
                if s.imode == "P":
                    need(pos + block * s.nbands * bpp)
                    blk = np.frombuffer(
                        seg, dt, block * s.nbands, pos).reshape(
                        s.nppbv, s.nppbh, s.nbands)
                    pos += block * s.nbands * bpp
                    if vr > 0 and vc > 0:
                        out[r0:r0 + vr, c0:c0 + vc] = blk[:vr, :vc]
                else:
                    for b in range(s.nbands):
                        need(pos + block * bpp)
                        blk = np.frombuffer(
                            seg, dt, block, pos).reshape(
                            s.nppbv, s.nppbh)
                        pos += block * bpp
                        if vr > 0 and vc > 0:
                            out[r0:r0 + vr, c0:c0 + vc, b] = \
                                blk[:vr, :vc]
    elif s.imode == "S":
        pos = 0
        for b in range(s.nbands):
            for br in range(s.nbpc):
                for bc in range(s.nbpr):
                    r0, c0 = br * s.nppbv, bc * s.nppbh
                    vr = min(s.nppbv, s.nrows - r0)
                    vc = min(s.nppbh, s.ncols - c0)
                    need(pos + block * bpp)
                    blk = np.frombuffer(seg, dt, block, pos).reshape(
                        s.nppbv, s.nppbh)
                    pos += block * bpp
                    if vr > 0 and vc > 0:
                        out[r0:r0 + vr, c0:c0 + vc, b] = blk[:vr, :vc]
    else:
        raise ValueError(f"NITF IMODE {s.imode!r} is not supported")
    info = RasterInfo(width=s.ncols, height=s.nrows, count=s.nbands,
                      dtype=s.dtype, geotransform=s.geotransform,
                      epsg=s.epsg)
    return GeoTIFF(out, info)


# ---------------------------------------------------------------------------
# fixture encoder (spec-shaped NC files for hermetic tests/examples)
# ---------------------------------------------------------------------------

def _pad(s: str, n: int) -> bytes:
    b = s.encode("ascii")
    if len(b) > n:
        raise ValueError(f"field too long: {s!r} > {n}")
    return b.ljust(n)


def _num(v: int, n: int) -> bytes:
    return str(int(v)).rjust(n, "0").encode("ascii")


# the all-blank 166-byte NITF 2.1 security block (file + image
# subheaders share the layout)
_SEC_BLANK = (b" " * 2 + b" " * 11 + b" " * 2 + b" " * 20 + b" " * 2
              + b" " * 8 + b" " * 4 + b" " * 1 + b" " * 8 + b" " * 43
              + b" " * 1 + b" " * 40 + b" " * 1 + b" " * 8
              + b" " * 15)


def encode_nitf(array: np.ndarray, imode: str = "B",
                block_size: Optional[int] = None,
                geotransform: Optional[Tuple[float, ...]] = None,
                epsg: Optional[int] = None,
                compression: str = "NC") -> bytes:
    """Minimal single-image-segment NITF 2.1. array: (H, W) or
    (H, W, B) of uint8/uint16/int16/float32. ICORDS=N/S corners are
    written when an axis-aligned UTM geotransform + EPSG:326xx/327xx
    are given. compression: "NC" (raw blocks) or "C8" (one JPEG 2000
    codestream through the port's raster/jp2.py; single block)."""
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, nb = arr.shape
    if nb > 9:
        raise ValueError("fixture encoder supports <= 9 bands")
    kind = {"uint8": ("INT", 8), "uint16": ("INT", 16),
            "int16": ("SI", 16), "float32": ("R", 32)}.get(
        arr.dtype.name)
    if kind is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    pvtype, nbpp = kind
    bs = block_size or max(h, w)
    if compression == "C8":
        bs = max(h, w)  # single block per spec usage here
    # NPPBH/NPPBV have 4 digits: a block above 9999 pixels is written as
    # 0000, one block the size of the image (the JAX package writes
    # 9999 and blocks of bs, which decode to other pixels)
    whole = bs > 9999
    if whole and bs < max(h, w):
        raise ValueError(f"NITF blocks of {bs} pixels: a block above "
                         "9999 pixels must hold the whole image")
    bh, bw = (h, w) if whole else (bs, bs)
    nbpr = (w + bw - 1) // bw
    nbpc = (h + bh - 1) // bh

    icords, igeolo = " ", b""
    if geotransform is not None and epsg is not None and \
            32601 <= epsg <= 32760 and geotransform[2] == 0 \
            and geotransform[4] == 0:
        zone = epsg % 100
        icords = "N" if epsg < 32700 else "S"
        gt = geotransform

        def corner(col, row):
            e = gt[0] + col * gt[1]
            n = gt[3] + row * gt[5]
            return (_num(zone, 2) + _num(round(e), 6)
                    + _num(round(n), 7))

        igeolo = (corner(0, 0) + corner(w, 0) + corner(w, h)
                  + corner(0, h))

    sec = _SEC_BLANK

    sub = bytearray()
    sub += b"IM" + _pad("DLSEG", 10) + _pad("20201101000000", 14)
    sub += _pad("", 17) + _pad("synthetic", 80)
    sub += b"U" + sec + b"0"          # ISCLAS, security, ENCRYP
    sub += _pad("dlseg-tpu", 42)
    sub += _num(h, 8) + _num(w, 8) + _pad(pvtype, 3)
    sub += _pad("MULTI" if nb > 1 else "MONO", 8)   # IREP
    sub += _pad("VIS", 8) + _num(nbpp, 2) + b"R"     # ICAT ABPP PJUST
    sub += icords.encode("ascii")
    sub += igeolo
    sub += b"0"                        # NICOM
    sub += compression.encode("ascii")  # IC
    if compression not in ("NC", "NM"):
        sub += _pad("N/A", 4)          # COMRAT
    sub += _num(nb, 1)
    for _ in range(nb):
        sub += _pad("M", 2) + _pad("", 6) + b"N" + _pad("", 3) + b"0"
    sub += b"0"                        # ISYNC
    sub += imode.encode("ascii")
    sub += _num(nbpr, 4) + _num(nbpc, 4)
    sub += b"00000000" if whole else _num(bs, 4) + _num(bs, 4)
    sub += _num(nbpp, 2)
    sub += _num(1, 3) + _num(0, 3) + _num(0, 10) + _pad("1.0 ", 4)
    sub += _num(0, 5) + _num(0, 5)    # UDIDL, IXSHDL

    dt = np.dtype(arr.dtype).newbyteorder(">")
    blocks = bytearray()
    if compression == "C8":
        blocks += encode_jp2(arr)
    else:
        _encode_nc_blocks(arr, imode, bh, bw, nbpr, nbpc, dt, blocks)
    return _assemble(sub, blocks)


def _encode_nc_blocks(arr, imode, bh, bw, nbpr, nbpc, dt, blocks):
    h, w, nb = arr.shape
    for br in range(nbpc):
        for bc in range(nbpr):
            full = np.zeros((bh, bw, nb), arr.dtype)
            r0, c0 = br * bh, bc * bw
            vr = min(bh, h - r0)
            vc = min(bw, w - c0)
            full[:vr, :vc] = arr[r0:r0 + vr, c0:c0 + vc]
            if imode == "P":
                blocks += full.astype(dt).tobytes()
            elif imode == "B":
                for b in range(nb):
                    blocks += full[:, :, b].astype(dt).tobytes()
            elif imode != "S":  # S is band-major: written below
                raise ValueError(f"unsupported IMODE {imode!r}")
    if imode == "S":
        for b in range(nb):
            for br in range(nbpc):
                for bc in range(nbpr):
                    full = np.zeros((bh, bw), arr.dtype)
                    r0, c0 = br * bh, bc * bw
                    vr = min(bh, h - r0)
                    vc = min(bw, w - c0)
                    full[:vr, :vc] = arr[r0:r0 + vr, c0:c0 + vc, b]
                    blocks += full.astype(dt).tobytes()


def _assemble(sub, blocks) -> bytes:
    hdr = bytearray()
    hdr += b"NITF02.10" + _num(3, 2) + _pad("BF01", 4)
    hdr += _pad("DLSEG", 10) + _pad("20201101000000", 14)
    hdr += _pad("dl_image_segmentation_tpu synthetic", 80)
    hdr += b"U" + _SEC_BLANK + _num(0, 5) + _num(0, 5) + b"0"
    hdr += b"\x00\x00\x00"            # FBKGC (binary)
    hdr += _pad("", 24) + _pad("", 18)
    # FL (patched below), HL, segment table
    fl_pos = len(hdr)
    hdr += _num(0, 12)
    hl_pos = len(hdr)
    hdr += _num(0, 6)
    hdr += _num(1, 3) + _num(len(sub), 6) + _num(len(blocks), 10)
    hdr += _num(0, 3)                 # NUMS
    hdr += _num(0, 3)                 # NUMX
    hdr += _num(0, 3)                 # NUMT
    hdr += _num(0, 3)                 # NUMDES
    hdr += _num(0, 3)                 # NUMRES
    hdr += _num(0, 5) + _num(0, 5)    # UDHDL, XHDL
    hl = len(hdr)
    total = hl + len(sub) + len(blocks)
    hdr[fl_pos:fl_pos + 12] = _num(total, 12)
    hdr[hl_pos:hl_pos + 6] = _num(hl, 6)
    return bytes(hdr) + bytes(sub) + bytes(blocks)
