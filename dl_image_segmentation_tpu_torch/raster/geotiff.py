"""GeoTIFF codec: reader and chip writer, pure Python + numpy with the
native LZW encoder.

Replaces the GDAL GeoTIFF writer the reference uses
(dl_segmentation_utils/_descartes_img_chips.py:782-798:
``COMPRESS=LZW, TILED=TRUE`` chips with projection, geotransform and
label nodata). The on-disk chip contract is preserved: LZW-compressed
tiled GeoTIFF, multi-band any-dtype images, single-band uint8 labels
with a nodata value in the metadata. Reads and writes go to local
paths; object storage schemes come with the storage slice of the port.

Reader support: classic TIFF and BigTIFF, II/MM byte order, strip or
tile layout, compression none/LZW/Deflate(8/32946)/PackBits, predictor
1/2/3, planar configuration 1 (chunky) and 2 (separate),
uint8..64/int8..32/float32/64, GDAL_NODATA, ModelPixelScale +
ModelTiepoint, GeoKeyDirectory EPSG.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .lzw import lzw_decode_native, lzw_encode_native

# TIFF tag ids
_T_IMAGE_WIDTH = 256
_T_IMAGE_LENGTH = 257
_T_BITS_PER_SAMPLE = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_STRIP_OFFSETS = 273
_T_SAMPLES_PER_PIXEL = 277
_T_ROWS_PER_STRIP = 278
_T_STRIP_BYTE_COUNTS = 279
_T_PLANAR_CONFIG = 284
_T_PREDICTOR = 317
_T_TILE_WIDTH = 322
_T_TILE_LENGTH = 323
_T_TILE_OFFSETS = 324
_T_TILE_BYTE_COUNTS = 325
_T_SAMPLE_FORMAT = 339
_T_MODEL_PIXEL_SCALE = 33550
_T_MODEL_TIEPOINT = 33922
_T_GEO_KEY_DIRECTORY = 34735
_T_GDAL_NODATA = 42113

# TIFF field types: id -> (struct char, size)
_FIELD_TYPES = {
    1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
    6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
    11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8),
}

_SAMPLEFORMAT_UINT = 1
_SAMPLEFORMAT_INT = 2
_SAMPLEFORMAT_FLOAT = 3


def _np_dtype(bits: int, fmt: int, byteorder: str) -> np.dtype:
    kind = {_SAMPLEFORMAT_UINT: "u", _SAMPLEFORMAT_INT: "i",
            _SAMPLEFORMAT_FLOAT: "f"}.get(fmt, "u")
    return np.dtype(f"{byteorder}{kind}{bits // 8}")


@dataclass
class RasterInfo:
    """Decoded georeferencing + metadata of a GeoTIFF."""
    width: int = 0
    height: int = 0
    count: int = 1
    dtype: str = "uint8"
    geotransform: Optional[Tuple[float, ...]] = None
    epsg: Optional[int] = None
    wkt: Optional[str] = None
    nodata: Optional[float] = None

    @property
    def crs(self) -> Optional[str]:
        return f"EPSG:{self.epsg}" if self.epsg else None


class GeoTIFF:
    """A decoded GeoTIFF: ``array`` is always bands-last 3D (height,
    width, bands), rasterio's reshape_as_image convention that the
    reference uses (_img_to_tf_mp.py:69)."""

    def __init__(self, array: np.ndarray, info: RasterInfo):
        self.array = array
        self.info = info


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _ifd_value_bytes(buf, fmt, total, val_bytes, big=False):
    """The ``total`` bytes of an entry's values: inline in its value
    field ``val_bytes``, or at the offset the field holds (fewer where
    the data ends first)."""
    if total <= (8 if big else 4):
        return val_bytes[:total]
    (off,) = struct.unpack(fmt + ("Q" if big else "I"), val_bytes)
    return buf[off:off + total]


def _read_ifd_values(buf, fmt, ttype, count, val_bytes, big=False):
    ch, size = _FIELD_TYPES.get(ttype, ("B", 1))
    raw = _ifd_value_bytes(buf, fmt, size * count, val_bytes, big)
    if ttype == 2:  # ASCII
        return raw.split(b"\x00")[0].decode("latin-1")
    if ttype in (5, 10):  # rational
        vals = struct.unpack(fmt + ("Ii"[ttype == 10] * 2 * count), raw)
        return [vals[2 * i] / max(vals[2 * i + 1], 1) for i in range(count)]
    vals = struct.unpack(fmt + ch * count, raw)
    return list(vals)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        i += 1
        if b < 128:
            out += data[i:i + b + 1]
            i += b + 1
        elif b > 128:
            out += data[i:i + 1] * (257 - b)
            i += 1
    return bytes(out)


def _parse_ifd(data: bytes):
    """Parse the first IFD of a classic TIFF (version 42) or BigTIFF
    (version 43: 8-byte offsets, 20-byte IFD entries)."""
    if data[:4] == b"II*\x00":
        fmt, big = "<", False
    elif data[:4] == b"MM\x00*":
        fmt, big = ">", False
    elif data[:4] in (b"II+\x00", b"MM\x00+"):
        fmt = "<" if data[0:1] == b"I" else ">"
        big = True
        offsize, zero = struct.unpack(fmt + "HH", data[4:8])
        if offsize != 8 or zero != 0:
            raise ValueError(f"malformed BigTIFF header "
                             f"(offset size {offsize})")
    else:
        raise ValueError("not a TIFF")
    (ifd_off,) = struct.unpack(fmt + ("Q" if big else "I"),
                               data[8:16] if big else data[4:8])
    tags: Dict[int, list] = {}
    for tid, ttype, cnt, val_bytes in _ifd_entries(data, fmt, big, ifd_off):
        tags[tid] = _read_ifd_values(data, fmt, ttype, cnt, val_bytes, big)
    return fmt, tags


def _ifd_entries(data: bytes, fmt: str, big: bool, ifd_off: int):
    """(tag, type, count, value field) of each entry of the IFD at
    ``ifd_off``; ``struct.error`` where the data ends before an entry's
    count, and a short value field where it ends inside it."""
    count, head, field = (fmt + "Q", fmt + "HHQ", 8) if big else \
        (fmt + "H", fmt + "HHI", 4)
    p = ifd_off + struct.calcsize(count)
    (ntags,) = struct.unpack(count, data[ifd_off:p])
    for _ in range(ntags):
        q = p + struct.calcsize(head)
        tid, ttype, cnt = struct.unpack(head, data[p:q])
        yield tid, ttype, cnt, data[q:q + field]
        p = q + field


def _geo_info_from_tags(tags, info: "RasterInfo") -> None:
    """Fill geotransform / EPSG / WKT / nodata on ``info`` from tags."""
    scale = tags.get(_T_MODEL_PIXEL_SCALE)
    tie = tags.get(_T_MODEL_TIEPOINT)
    if scale and tie and len(tie) >= 6:
        sx, sy = float(scale[0]), float(scale[1])
        i, j, _k, x, y, _z = (float(v) for v in tie[:6])
        origin_x = x - i * sx
        origin_y = y + j * sy
        info.geotransform = (origin_x, sx, 0.0, origin_y, 0.0, -sy)
    gkd = tags.get(_T_GEO_KEY_DIRECTORY)
    if gkd and len(gkd) >= 4:
        nkeys = int(gkd[3])
        for k in range(nkeys):
            base = 4 + k * 4
            key_id, loc, cnt, val = (int(v) for v in gkd[base:base + 4])
            if key_id == 3072 and loc == 0:  # ProjectedCSTypeGeoKey
                info.epsg = val
            elif key_id == 2048 and loc == 0 and info.epsg is None:
                info.epsg = val  # GeographicTypeGeoKey
    nod = tags.get(_T_GDAL_NODATA)
    if nod is not None:
        try:
            info.nodata = float(str(nod).strip())
        except ValueError:
            pass
    if info.epsg and 32601 <= info.epsg <= 32660:
        from ..geo import crs as _crs
        info.wkt = _crs.utm_wkt(info.epsg - 32600, north=True)
    elif info.epsg and 32701 <= info.epsg <= 32760:
        from ..geo import crs as _crs
        info.wkt = _crs.utm_wkt(info.epsg - 32700, north=False)


def decode_geotiff_info(data: bytes) -> RasterInfo:
    """Header-only parse: shape, dtype, band count, geo tags -- no
    pixel decode."""
    fmt, tags = _parse_ifd(data)
    bps_list = tags.get(_T_BITS_PER_SAMPLE, [8])
    if isinstance(bps_list, str):
        bps_list = [8]
    sfmt = int(tags.get(_T_SAMPLE_FORMAT, [_SAMPLEFORMAT_UINT])[0])
    info = RasterInfo(
        width=int(tags[_T_IMAGE_WIDTH][0]),
        height=int(tags[_T_IMAGE_LENGTH][0]),
        count=int(tags.get(_T_SAMPLES_PER_PIXEL, [1])[0]),
        dtype=np.dtype(_np_dtype(int(bps_list[0]), sfmt, fmt)).name)
    _geo_info_from_tags(tags, info)
    return info


class _Layout:
    """Parsed pixel-storage layout of one TIFF IFD: everything needed
    to turn a raw chunk (tile or strip) into pixels, wherever the chunk
    bytes come from (a whole in-memory buffer here; ranged reads in
    raster/cog.py)."""

    def __init__(self, fmt: str, tags: Dict[int, list]):
        self.fmt = fmt
        self.tags = tags
        self.width = int(tags[_T_IMAGE_WIDTH][0])
        self.height = int(tags[_T_IMAGE_LENGTH][0])
        self.spp = int(tags.get(_T_SAMPLES_PER_PIXEL, [1])[0])
        bps_list = tags.get(_T_BITS_PER_SAMPLE, [8])
        if isinstance(bps_list, str):
            bps_list = [8]
        self.bps = int(bps_list[0])
        self.comp = int(tags.get(_T_COMPRESSION, [1])[0])
        self.planar = int(tags.get(_T_PLANAR_CONFIG, [1])[0])
        self.predictor = int(tags.get(_T_PREDICTOR, [1])[0])
        sfmt = int(tags.get(_T_SAMPLE_FORMAT, [_SAMPLEFORMAT_UINT])[0])
        self.dtype = _np_dtype(self.bps, sfmt, fmt)
        self.tiled = _T_TILE_OFFSETS in tags
        self.nplanes = self.spp if self.planar == 2 else 1
        self.samples_per_px = 1 if self.planar == 2 else self.spp
        if self.tiled:
            self.tile_w = int(tags[_T_TILE_WIDTH][0])
            self.tile_h = int(tags[_T_TILE_LENGTH][0])
            self.offsets = [int(v) for v in tags[_T_TILE_OFFSETS]]
            self.counts = [int(v) for v in tags[_T_TILE_BYTE_COUNTS]]
            self.tiles_across = -(-self.width // self.tile_w)
            self.tiles_down = -(-self.height // self.tile_h)
        else:
            rps = int(tags.get(_T_ROWS_PER_STRIP, [self.height])[0])
            self.rows_per_strip = min(rps, self.height)
            self.offsets = [int(v) for v in tags[_T_STRIP_OFFSETS]]
            self.counts = [int(v) for v in tags[_T_STRIP_BYTE_COUNTS]]

        if self.predictor not in (1, 2, 3):
            raise ValueError(f"unsupported TIFF predictor "
                             f"{self.predictor}")
        if self.predictor == 3 and self.dtype.kind != "f":
            raise ValueError(
                "TIFF floating-point predictor (3) on non-float samples")
        if self.predictor == 2 and self.dtype.kind == "f":
            # the int-domain cumsum would truncate fractional deltas --
            # refuse rather than silently decode garbage (the symmetric
            # guard to predictor 3 + non-float above)
            raise ValueError(
                "TIFF horizontal predictor (2) on float samples is not "
                "supported; re-encode with predictor 1 or 3")
        if int(tags.get(_T_PHOTOMETRIC, [1])[0]) == 3:
            raise ValueError(
                "palette-color TIFF (photometric 3) is not supported: "
                "palette indices are not pixel values; convert to RGB "
                "(e.g. gdal_translate -expand rgb) before ingestion")

    def decompress(self, chunk: bytes, expect: int) -> bytes:
        if self.comp == 1:
            return chunk
        if self.comp == 5:
            return lzw_decode_native(chunk, max_size=expect)
        if self.comp in (8, 32946):
            return zlib.decompress(chunk)
        if self.comp == 32773:
            return _packbits_decode(chunk)
        raise NotImplementedError(
            f"TIFF compression {self.comp} is not supported by the port's "
            "reader (none, LZW, Deflate and PackBits are)")

    def chunk_to_array(self, raw: bytes, nrows: int,
                       ncols: int) -> np.ndarray:
        """Decoded chunk bytes -> (nrows, ncols, samples) array with
        the chunk's predictor undone."""
        if self.predictor == 3:
            return _undo_fpredictor(raw, nrows, ncols,
                                    self.samples_per_px, self.dtype)
        arr = np.frombuffer(
            raw, dtype=self.dtype,
            count=nrows * ncols * self.samples_per_px).reshape(
                nrows, ncols, self.samples_per_px)
        if self.predictor == 2:
            arr = _undo_hpredictor(arr)
        return arr

    def decode_chunk(self, raw_chunk: bytes, nrows: int,
                     ncols: int) -> np.ndarray:
        expect = nrows * ncols * self.samples_per_px * self.dtype.itemsize
        return self.chunk_to_array(self.decompress(raw_chunk, expect),
                                   nrows, ncols)


def decode_geotiff(data: bytes) -> GeoTIFF:
    """Decode a GeoTIFF (or plain TIFF) from bytes."""
    fmt, tags = _parse_ifd(data)
    lay = _Layout(fmt, tags)
    height, width = lay.height, lay.width
    if lay.tiled:  # tiles are stored whole, also past the raster's edge
        chunks = [(y, x, lay.tile_h, lay.tile_w)
                  for y in range(0, height, lay.tile_h)
                  for x in range(0, width, lay.tile_w)]
    else:  # the last strip ends at the last row
        rps = lay.rows_per_strip
        chunks = [(y, 0, min(rps, height - y), width)
                  for y in range(0, height, rps)]
    # chunky (planar 1): one plane of all samples; separate (planar 2):
    # one plane a band, its chunks after the previous band's
    out = np.zeros((lay.nplanes, height, width, lay.samples_per_px),
                   lay.dtype)
    idx = 0
    for plane in out:
        for y0, x0, nrows, ncols in chunks:
            off, cnt = lay.offsets[idx], lay.counts[idx]
            idx += 1
            arr = lay.decode_chunk(data[off:off + cnt], nrows, ncols)
            h, w = min(nrows, height - y0), min(ncols, width - x0)
            plane[y0:y0 + h, x0:x0 + w] = arr[:h, :w]
    out = np.moveaxis(out, 0, 2).reshape(height, width, lay.spp)

    info = RasterInfo(width=width, height=height, count=lay.spp,
                      dtype=lay.dtype.name)
    _geo_info_from_tags(tags, info)
    out = np.ascontiguousarray(out)
    if fmt == ">":
        out = out.astype(out.dtype.newbyteorder("="))
    return GeoTIFF(out, info)


def _undo_fpredictor(raw: bytes, nrows: int, ncols: int, spp: int,
                     dtype: np.dtype) -> np.ndarray:
    """Undo the TIFF floating-point predictor (3, TIFF TechNote 3):
    the encoder splits each row's values into big-endian byte planes
    (all MSBs first, then the next byte of every value, ...) and then
    horizontally differences the reordered row bytes. GDAL writes this
    for float rasters with PREDICTOR=3."""
    k = dtype.itemsize
    n = ncols * spp
    b = np.frombuffer(raw, np.uint8,
                      count=nrows * n * k).reshape(nrows, k * n)
    # mod-256 cumulative sum per row undoes the byte differencing
    b = np.cumsum(b, axis=1, dtype=np.uint64).astype(np.uint8)
    planes = b.reshape(nrows, k, n)               # byte plane p of row
    interleaved = np.ascontiguousarray(planes.transpose(0, 2, 1))
    vals = interleaved.reshape(nrows, n * k).view(dtype.newbyteorder(">"))
    return vals.reshape(nrows, ncols, spp).astype(dtype, copy=False)


def _undo_hpredictor(arr: np.ndarray) -> np.ndarray:
    # horizontal differencing predictor: cumulative sum along rows
    return np.cumsum(arr, axis=1, dtype=np.int64).astype(arr.dtype)


def read_geotiff(path: str) -> GeoTIFF:
    """Decode a GeoTIFF from a local path or a gs://, s3:// or
    http(s):// object."""
    from .. import storage
    return decode_geotiff(storage.read_bytes(path))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _sample_format_of(dtype: np.dtype) -> int:
    if dtype.kind == "u":
        return _SAMPLEFORMAT_UINT
    if dtype.kind == "i":
        return _SAMPLEFORMAT_INT
    if dtype.kind == "f":
        return _SAMPLEFORMAT_FLOAT
    raise ValueError(f"unsupported dtype {dtype}")


def encode_geotiff(
    array: np.ndarray,
    geotransform: Optional[Sequence[float]] = None,
    epsg: Optional[int] = None,
    nodata: Optional[float] = None,
    compress: str = "lzw",
    tiled: bool = True,
    tile_size: int = 256,
    bigtiff=False,
) -> bytes:
    """Encode (H, W) or (H, W, B) array to GeoTIFF bytes.

    Default layout matches the reference chip contract: LZW, tiled
    (COMPRESS=LZW TILED=TRUE, _descartes_img_chips.py:784), chunky
    planar config, little-endian classic TIFF. ``bigtiff=True`` emits
    the BigTIFF (version 43) container with 64-bit offsets -- for
    mosaics past the 4 GiB classic limit (e.g. stitch output).
    ``bigtiff="auto"`` decides from the ACTUAL compressed sizes (LZW
    can expand incompressible data ~1.3x, so a raw-size heuristic at
    the caller can pick classic TIFF and then overflow its offsets).
    """
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError("array must be (H,W) or (H,W,B)")
    h, w, b = arr.shape
    dtype = arr.dtype.newbyteorder("<")
    arr = np.ascontiguousarray(arr, dtype=dtype)

    comp_id = {"none": 1, "lzw": 5, "deflate": 8, "zip": 8}[compress.lower()]

    def compress_chunk(chunk: np.ndarray) -> bytes:
        raw = chunk.tobytes()
        if comp_id == 1:
            return raw
        if comp_id == 5:
            return lzw_encode_native(raw)
        return zlib.compress(raw, 6)

    chunks: List[bytes] = []
    if tiled:
        ts = tile_size if max(h, w) >= tile_size else 16 * max(
            1, (max(h, w) + 15) // 16)
        tiles_across = -(-w // ts)
        tiles_down = -(-h // ts)
        for tj in range(tiles_down):
            for ti in range(tiles_across):
                tile = np.zeros((ts, ts, b), dtype=dtype)
                y0, x0 = tj * ts, ti * ts
                y1, x1 = min(y0 + ts, h), min(x0 + ts, w)
                tile[: y1 - y0, : x1 - x0] = arr[y0:y1, x0:x1]
                chunks.append(compress_chunk(tile))
    else:
        chunks.append(compress_chunk(arr))

    if bigtiff == "auto":
        # decided from real compressed bytes: data + header/IFD plus a
        # PER-CHUNK budget -- offset/bytecount overflow arrays grow
        # 8-16 bytes per chunk, which at ~100k+ tiles dwarfs the fixed
        # kilobytes a flat bound would allow
        bigtiff = (sum(len(c) for c in chunks) + (1 << 20)
                   + 24 * len(chunks) > 0xFFFFFFFF)

    # assemble tags; photometric RGB for 3-band uint8 (like GDAL), else
    # MinIsBlack with ExtraSamples covering the additional bands
    photometric = 2 if (b == 3 and dtype == np.uint8) else 1
    implied = 3 if photometric == 2 else 1
    tags: List[Tuple[int, int, int, object]] = [
        (_T_IMAGE_WIDTH, 3, 1, w),
        (_T_IMAGE_LENGTH, 3, 1, h),
        (_T_BITS_PER_SAMPLE, 3, b, [dtype.itemsize * 8] * b),
        (_T_COMPRESSION, 3, 1, comp_id),
        (_T_PHOTOMETRIC, 3, 1, photometric),
        (_T_SAMPLES_PER_PIXEL, 3, 1, b),
        (_T_PLANAR_CONFIG, 3, 1, 1),
        (_T_SAMPLE_FORMAT, 3, b, [_sample_format_of(dtype)] * b),
    ]
    if b > implied:
        tags.append((338, 3, b - implied, [0] * (b - implied)))
    off_type = 16 if bigtiff else 4  # LONG8 in BigTIFF
    if tiled:
        tags += [
            (_T_TILE_WIDTH, 3, 1, ts),
            (_T_TILE_LENGTH, 3, 1, ts),
            (_T_TILE_OFFSETS, off_type, len(chunks), "OFFSETS"),
            (_T_TILE_BYTE_COUNTS, 4, len(chunks), [len(c) for c in chunks]),
        ]
    else:
        tags += [
            (_T_ROWS_PER_STRIP, 3, 1, h),
            (_T_STRIP_OFFSETS, off_type, 1, "OFFSETS"),
            (_T_STRIP_BYTE_COUNTS, 4, 1, [len(chunks[0])]),
        ]
    if geotransform is not None:
        gt = [float(v) for v in geotransform]
        tags.append((_T_MODEL_PIXEL_SCALE, 12, 3, [gt[1], -gt[5], 0.0]))
        tags.append((_T_MODEL_TIEPOINT, 12, 6,
                     [0.0, 0.0, 0.0, gt[0], gt[3], 0.0]))
    if epsg is not None:
        if 4000 <= epsg <= 4999:  # geographic CRS (e.g. 4326 WGS84)
            gk = [1, 1, 0, 3,
                  1024, 0, 1, 2,      # GTModelType = geographic
                  1025, 0, 1, 1,      # GTRasterType = PixelIsArea
                  2048, 0, 1, epsg]   # GeographicType
        else:
            gk = [1, 1, 0, 3,
                  1024, 0, 1, 1,      # GTModelType = projected
                  1025, 0, 1, 1,      # GTRasterType = PixelIsArea
                  3072, 0, 1, epsg]   # ProjectedCSType
        tags.append((_T_GEO_KEY_DIRECTORY, 3, len(gk), gk))
    if nodata is not None:
        import math
        nodata_f = float(nodata)
        nd = (f"{int(nodata_f)}"
              if math.isfinite(nodata_f) and nodata_f == int(nodata_f)
              else repr(nodata_f)) + "\x00"
        tags.append((_T_GDAL_NODATA, 2, len(nd), nd))

    tags.sort(key=lambda t: t[0])

    # layout: header + IFD + overflow values + chunk data
    # (classic: 8-byte header, 12-byte entries, 4-byte inline values;
    #  BigTIFF: 16-byte header, 20-byte entries, 8-byte inline values)
    n = len(tags)
    head_size = 16 if bigtiff else 8
    entry_size = 20 if bigtiff else 12
    count_size = 8 if bigtiff else 2
    next_size = 8 if bigtiff else 4
    inline = 8 if bigtiff else 4
    ifd_size = count_size + n * entry_size + next_size
    overflow = bytearray()
    entries = bytearray()
    # first pass to size overflow
    sized = []
    for tid, ttype, cnt, val in tags:
        ch, unit = _FIELD_TYPES[ttype]
        total = unit * cnt
        sized.append(total)
    overflow_total = sum(t for t in sized if t > inline)
    chunk_start = head_size + ifd_size + overflow_total
    # word-align chunk data
    if chunk_start % 2:
        chunk_start += 1
    chunk_offsets = []
    pos = chunk_start
    for c in chunks:
        chunk_offsets.append(pos)
        pos += len(c)
    if not bigtiff and pos > 0xFFFFFFFF:
        raise ValueError(
            f"encoded size {pos} bytes exceeds the classic TIFF 4 GiB "
            "offset limit; pass bigtiff=True (or bigtiff='auto')")

    over_pos = head_size + ifd_size
    for (tid, ttype, cnt, val), total in zip(tags, sized):
        ch, unit = _FIELD_TYPES[ttype]
        if val == "OFFSETS":
            val = chunk_offsets
        if ttype == 2:
            raw = val.encode("latin-1") if isinstance(val, str) else bytes(val)
        elif isinstance(val, (list, tuple)):
            raw = struct.pack("<" + ch * cnt, *val)
        else:
            raw = struct.pack("<" + ch, val)
        if bigtiff:
            entries += struct.pack("<HHQ", tid, ttype, cnt)
        else:
            entries += struct.pack("<HHI", tid, ttype, cnt)
        if total <= inline:
            entries += raw.ljust(inline, b"\x00")
        else:
            entries += struct.pack("<Q" if bigtiff else "<I", over_pos)
            overflow += raw
            over_pos += total

    out = bytearray()
    if bigtiff:
        out += b"II+\x00" + struct.pack("<HHQ", 8, 0, 16)
        out += struct.pack("<Q", n) + entries + struct.pack("<Q", 0)
    else:
        out += b"II*\x00" + struct.pack("<I", 8)
        out += struct.pack("<H", n) + entries + struct.pack("<I", 0)
    out += overflow
    out += b"\x00" * (chunk_start - len(out))
    for c in chunks:
        out += c
    return bytes(out)


def write_geotiff(path: str, array: np.ndarray, **kwargs) -> None:
    """Atomic write: existence == complete, so the chip pipeline's
    is_done resume never accepts a torn file from a crashed run. Local:
    tmp + rename; gs:// and s3://: spooled, then one streamed upload
    (GCS resumable / S3 multipart), an atomic object creation."""
    from .. import storage
    if storage.is_remote(path):
        w = storage.SpooledWriter(path)
        try:
            w.write(encode_geotiff(array, **kwargs))
        except BaseException:
            w.abort()
            raise
        w.close()
        return
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(encode_geotiff(array, **kwargs))
    os.replace(tmp, path)
