"""ENVI raster decoder and encoder.

A copy of the JAX package's ``raster/envi.py``. ENVI is a two-file
format: a text header (``foo.hdr``) describing a flat binary data file
(``foo.img``/``foo.dat``/...). This module implements:

* the header grammar (``key = value``, brace-delimited multi-line
  values, case-insensitive keys);
* BSQ / BIL / BIP interleaves, all integer/float data types, both
  byte orders, ``header offset``;
* georeferencing from ``map info`` (UTM zones -> EPSG:326xx/327xx,
  Geographic Lat/Lon -> EPSG:4326) or a ``coordinate system string``
  WKT with an EPSG authority code, plus ``data ignore value``;
* header-only sniffing (shape/dtype/geo come from the .hdr alone).

The entry point is the header file: the decoder finds the sibling data
file (GDAL's stem conventions: ``foo.hdr`` -> ``foo`` / ``foo.img`` /
``foo.dat`` / ...; ``foo.img.hdr`` -> ``foo.img``) from ``base_dir`` and
``origin`` through the port's ``storage``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .geotiff import GeoTIFF, RasterInfo

__all__ = ["is_envi_header", "decode_envi", "sniff_envi_info",
           "encode_envi"]

# ENVI "data type" codes -> numpy dtypes (complex types are rejected:
# no raster consumer downstream accepts them)
_DTYPES = {1: "uint8", 2: "int16", 3: "int32", 4: "float32",
           5: "float64", 12: "uint16", 13: "uint32", 14: "int64",
           15: "uint64"}
_DATA_EXTS = ("", ".img", ".dat", ".raw", ".bsq", ".bil", ".bip",
              ".bin")


def is_envi_header(data: bytes) -> bool:
    head = data[:16].lstrip()
    return head.startswith(b"ENVI") and (
        len(head) == 4 or head[4:5] in (b"\r", b"\n"))


def _parse_header(data: bytes) -> Dict[str, str]:
    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError:
        text = data.decode("latin-1")
    fields: Dict[str, str] = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.upper() == "ENVI" or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = " ".join(key.lower().split())
        value = value.strip()
        if value.startswith("{"):
            # brace-delimited values may span lines
            while "}" not in value and i < len(lines):
                value += " " + lines[i].strip()
                i += 1
            value = value[1:value.index("}")].strip()
        fields[key] = value
    return fields


def _epsg_from_fields(fields: Dict[str, str]
                      ) -> Tuple[Optional[Tuple[float, ...]],
                                 Optional[int]]:
    """(geotransform, epsg) from map info / coordinate system string."""
    gt = None
    epsg = None
    mi = fields.get("map info")
    if mi:
        parts = [p.strip() for p in mi.split(",")]
        proj = parts[0].lower()
        refx, refy = float(parts[1]), float(parts[2])
        east, north = float(parts[3]), float(parts[4])
        xs, ys = float(parts[5]), float(parts[6])
        # reference pixel is 1-based; (1.0, 1.0) = the top-left CORNER
        # of the first pixel (GDAL's ENVI driver convention)
        gt = (east - (refx - 1.0) * xs, xs, 0.0,
              north + (refy - 1.0) * ys, 0.0, -ys)
        if proj == "utm" and len(parts) >= 9:
            zone = int(parts[7])
            south = parts[8].strip().lower().startswith("s")
            epsg = (32700 if south else 32600) + zone
        elif proj.startswith("geographic"):
            epsg = 4326
    wkt = fields.get("coordinate system string")
    if epsg is None and wkt:
        # last AUTHORITY["EPSG","nnn"] in the WKT is the full CRS code
        import re
        codes = re.findall(
            r'AUTHORITY\[\s*"EPSG"\s*,\s*"?(\d+)"?\s*\]', wkt)
        if codes:
            epsg = int(codes[-1])
    return gt, epsg


def _info_from_fields(fields: Dict[str, str]) -> RasterInfo:
    try:
        samples = int(fields["samples"])
        lines = int(fields["lines"])
        bands = int(fields.get("bands", "1"))
        dtype_code = int(fields["data type"])
    except KeyError as e:
        raise ValueError(f"ENVI header missing required field {e}")
    if dtype_code not in _DTYPES:
        raise ValueError(
            f"ENVI data type {dtype_code} is not supported "
            f"(supported: {sorted(_DTYPES)})")
    gt, epsg = _epsg_from_fields(fields)
    nodata = None
    if "data ignore value" in fields:
        nodata = float(fields["data ignore value"])
    return RasterInfo(width=samples, height=lines, count=bands,
                      dtype=_DTYPES[dtype_code], geotransform=gt,
                      epsg=epsg, nodata=nodata)


def sniff_envi_info(data: bytes) -> RasterInfo:
    """Shape/dtype/geo from the .hdr text alone (no data-file IO)."""
    if not is_envi_header(data):
        raise ValueError("not an ENVI header (must start with 'ENVI')")
    return _info_from_fields(_parse_header(data))


def _data_path(base_dir: Optional[str], origin: Optional[str]):
    """Candidate data-file paths for a header named ``origin``."""
    from .. import storage
    if base_dir is None or origin is None:
        return []
    stem = origin[:-4] if origin.lower().endswith(".hdr") else origin
    # "foo.img.hdr" -> "foo.img" (the bare stem), else "foo.hdr" ->
    # "foo" + the conventional data extensions; never split on other
    # dots (chip tile keys legitimately contain "." in the resolution)
    cands = [stem] + [stem + ext for ext in _DATA_EXTS if ext]
    return [storage.join(base_dir, c) for c in cands]


def decode_envi(header: bytes, base_dir: Optional[str] = None,
                origin: Optional[str] = None,
                data: Optional[bytes] = None) -> GeoTIFF:
    """ENVI header bytes -> bands-last raster.

    The flat binary file is found next to the header (``base_dir`` +
    ``origin`` stem, read through the storage layer) unless its bytes
    are passed directly via ``data``.
    """
    fields = _parse_header(header)
    info = _info_from_fields(fields)
    if data is None:
        from .. import storage
        tried = []
        for cand in _data_path(base_dir, origin):
            tried.append(cand)
            if storage.exists(cand):
                data = storage.read_bytes(cand)
                break
        if data is None:
            raise ValueError(
                "ENVI data file not found next to its header"
                + (f" (tried {tried})" if tried else
                   " (decode needs base_dir + origin, or data=)"))
    offset = int(fields.get("header offset", "0"))
    dt = np.dtype(info.dtype)
    if int(fields.get("byte order", "0")) == 1:
        dt = dt.newbyteorder(">")
    n = info.width * info.height * info.count
    need = offset + n * dt.itemsize
    if len(data) < need:
        raise ValueError(
            f"ENVI data file too short: {len(data)} bytes, header "
            f"promises {need}")
    flat = np.frombuffer(data, dtype=dt, count=n, offset=offset)
    interleave = fields.get("interleave", "bsq").lower()
    if interleave == "bsq":    # (bands, lines, samples)
        arr = flat.reshape(info.count, info.height, info.width)
        arr = np.transpose(arr, (1, 2, 0))
    elif interleave == "bil":  # (lines, bands, samples)
        arr = flat.reshape(info.height, info.count, info.width)
        arr = np.transpose(arr, (0, 2, 1))
    elif interleave == "bip":  # (lines, samples, bands)
        arr = flat.reshape(info.height, info.width, info.count)
    else:
        raise ValueError(
            f"ENVI interleave {interleave!r} is not supported "
            "(bsq, bil, bip)")
    arr = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder("=")))
    return GeoTIFF(arr, info)


# ---------------------------------------------------------------------------
# fixture encoder
# ---------------------------------------------------------------------------

def encode_envi(arr: np.ndarray, interleave: str = "bsq",
                geotransform: Optional[Tuple[float, ...]] = None,
                epsg: Optional[int] = None,
                nodata: Optional[float] = None,
                byte_order: int = 0) -> Tuple[bytes, bytes]:
    """(header bytes, data bytes) for a bands-last array. For test
    fixtures and round-trip validation."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, b = arr.shape
    code = {v: k for k, v in _DTYPES.items()}.get(arr.dtype.name)
    if code is None:
        raise ValueError(f"ENVI cannot hold dtype {arr.dtype.name}")
    lines = ["ENVI", "description = {dl_image_segmentation_tpu fixture}",
             f"samples = {w}", f"lines = {h}", f"bands = {b}",
             "header offset = 0", "file type = ENVI Standard",
             f"data type = {code}", f"interleave = {interleave}",
             f"byte order = {byte_order}"]
    if geotransform is not None and epsg is not None:
        gt = geotransform
        if epsg == 4326:
            proj = ["Geographic Lat/Lon"]
            tail = ["WGS-84"]
        elif 32601 <= epsg <= 32660 or 32701 <= epsg <= 32760:
            zone = epsg % 100
            hemi = "North" if epsg < 32700 else "South"
            proj = ["UTM"]
            tail = [str(zone), hemi, "WGS-84", "units=Meters"]
        else:
            raise ValueError(
                f"encode_envi map info supports UTM/geographic only, "
                f"got EPSG:{epsg}")
        mi = proj + ["1.0", "1.0", repr(gt[0]), repr(gt[3]),
                     repr(gt[1]), repr(-gt[5])] + tail
        lines.append("map info = {" + ", ".join(mi) + "}")
    if nodata is not None:
        lines.append(f"data ignore value = {nodata!r}")
    dt = arr.dtype.newbyteorder(">" if byte_order else "<")
    if interleave == "bsq":
        data = np.transpose(arr, (2, 0, 1))
    elif interleave == "bil":
        data = np.transpose(arr, (0, 2, 1))
    elif interleave == "bip":
        data = arr
    else:
        raise ValueError(f"unknown interleave {interleave!r}")
    return ("\n".join(lines) + "\n").encode(), \
        np.ascontiguousarray(data).astype(dt).tobytes()
