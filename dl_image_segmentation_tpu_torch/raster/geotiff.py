"""GeoTIFF writer for chips, pure Python + numpy with the native LZW
encoder.

Replaces the GDAL GeoTIFF writer the reference uses
(dl_segmentation_utils/_descartes_img_chips.py:782-798:
``COMPRESS=LZW, TILED=TRUE`` chips with projection, geotransform and
label nodata). The on-disk chip contract is preserved: LZW-compressed
tiled GeoTIFF, multi-band any-dtype images, single-band uint8 labels
with a nodata value in the metadata. Writes go to local paths; object
storage schemes come with the storage slice of the port.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .lzw import lzw_encode_native

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
    """Atomic local write: existence == complete, so the chip pipeline's
    is_done resume never accepts a torn file from a crashed run (tmp +
    rename)."""
    if "://" in path:
        raise NotImplementedError(
            f"cannot write {path!r}: object storage (gs://, s3://, "
            "https://) comes with the storage slice of the port")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(encode_geotiff(array, **kwargs))
    os.replace(tmp, path)
