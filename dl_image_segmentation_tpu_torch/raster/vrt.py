"""GDAL VRT (virtual raster, XML) decode: a minimal composer.

A copy of the JAX package's ``raster/vrt.py``, the commonly used core of
the VRT schema:

* ``VRTDataset`` size + ``GeoTransform`` + ``SRS`` (EPSG extracted);
* per-band ``VRTRasterBand`` with ``dataType``, ``NoDataValue``;
* ``SimpleSource`` / ``ComplexSource`` children: referenced file
  (``relativeToVRT`` handled), ``SourceBand``, ``SrcRect``/``DstRect``
  windows with nearest resampling (GDAL's VRT default), and
  ComplexSource ``ScaleOffset``/``ScaleRatio``/``NODATA``.

Sources are read through the port's ``storage`` and decoded through its
``decode_image_bytes``, so a VRT can mosaic GeoTIFF/PNG/JP2/... parts
that live locally or on gs:// / s3://. Unsupported VRT features
(KernelFilteredSource, warped VRTs, pixel functions) raise ValueError
naming the element.

A VRT references other files: ``decode_image_bytes(data,
base_dir=...)`` supplies the directory of the .vrt file itself, for
``relativeToVRT`` sources; absolute and URL paths work without it.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import Callable, Dict, Optional

import numpy as np

from .geotiff import GeoTIFF, RasterInfo

__all__ = ["is_vrt", "decode_vrt", "sniff_vrt_info"]

_DTYPES = {
    "Byte": "uint8", "UInt16": "uint16", "Int16": "int16",
    "UInt32": "uint32", "Int32": "int32", "Float32": "float32",
    "Float64": "float64",
}

_UNSUPPORTED_TAGS = ("KernelFilteredSource", "PixelFunctionType",
                     "GDALWarpOptions", "OverviewList", "MaskBand")


def is_vrt(data: bytes) -> bool:
    head = data.lstrip()[:200]
    if head.startswith(b"<?xml"):
        end = head.find(b"?>")
        head = head[end + 2:].lstrip() if end >= 0 else head
    return head.startswith(b"<VRTDataset")


def _parse(data: bytes) -> ET.Element:
    root = ET.fromstring(data.decode("utf-8"))
    if root.tag != "VRTDataset":
        raise ValueError(f"not a VRTDataset (root tag {root.tag!r})")
    if root.get("subClass"):
        raise ValueError(
            f"VRT subClass {root.get('subClass')!r} is not supported "
            "(plain VRTDataset only; flatten warped VRTs with "
            "gdal_translate first)")
    for tag in _UNSUPPORTED_TAGS:
        if root.find(f".//{tag}") is not None:
            raise ValueError(f"VRT element <{tag}> is not supported")
    return root


_EPSG_RE = re.compile(r'(?:AUTHORITY|ID)\["EPSG",\s*"?(\d+)"?\]\s*\]\s*$',
                      re.IGNORECASE)


def _info_from_xml(root: ET.Element) -> RasterInfo:
    w = int(root.get("rasterXSize", 0))
    h = int(root.get("rasterYSize", 0))
    bands = root.findall("VRTRasterBand")
    if not bands or w <= 0 or h <= 0:
        raise ValueError("VRT missing raster size or bands")
    dtype = _DTYPES.get(bands[0].get("dataType", "Byte"))
    if dtype is None:
        raise ValueError(
            f"VRT dataType {bands[0].get('dataType')!r} not supported")
    info = RasterInfo(width=w, height=h, count=len(bands), dtype=dtype)
    gt_el = root.find("GeoTransform")
    if gt_el is not None and gt_el.text:
        vals = [float(v) for v in gt_el.text.split(",")]
        if len(vals) == 6:
            info.geotransform = tuple(vals)
    srs_el = root.find("SRS")
    if srs_el is not None and srs_el.text:
        txt = srs_el.text.strip()
        m = re.fullmatch(r"EPSG:(\d+)", txt, re.IGNORECASE)
        if m:
            info.epsg = int(m.group(1))
        else:
            info.wkt = txt
            m = _EPSG_RE.search(txt)
            if m:
                info.epsg = int(m.group(1))
    nd = bands[0].find("NoDataValue")
    if nd is not None and nd.text:
        info.nodata = float(nd.text)
    return info


def _rect(el: Optional[ET.Element], w: int, h: int):
    if el is None:
        return 0, 0, w, h
    return (int(float(el.get("xOff", 0))), int(float(el.get("yOff", 0))),
            int(float(el.get("xSize", w))), int(float(el.get("ySize", h))))


def _nearest(src: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    if src.shape == (out_h, out_w):
        return src
    yy = np.minimum(((np.arange(out_h) + 0.5) * src.shape[0]
                     / out_h).astype(np.int64), src.shape[0] - 1)
    xx = np.minimum(((np.arange(out_w) + 0.5) * src.shape[1]
                     / out_w).astype(np.int64), src.shape[1] - 1)
    return src[yy[:, None], xx[None, :]]


def decode_vrt(data: bytes, base_dir: Optional[str] = None,
               open_fn: Optional[Callable[[str], bytes]] = None
               ) -> GeoTIFF:
    """Compose a VRT into a bands-last array using in-repo codecs."""
    from .image import decode_image_bytes

    if open_fn is None:
        from .. import storage
        open_fn = storage.read_bytes
    root = _parse(data)
    info = _info_from_xml(root)
    out = np.zeros((info.height, info.width, info.count),
                   dtype=info.dtype)
    if info.nodata is not None:
        out[:] = np.asarray(info.nodata).astype(info.dtype)
    cache: Dict[str, GeoTIFF] = {}
    for bi, band_el in enumerate(root.findall("VRTRasterBand")):
        nd_el = band_el.find("NoDataValue")
        if nd_el is not None and nd_el.text:
            out[:, :, bi] = np.asarray(
                float(nd_el.text)).astype(info.dtype)
        for src_el in band_el:
            if src_el.tag not in ("SimpleSource", "ComplexSource"):
                continue
            fn_el = src_el.find("SourceFilename")
            if fn_el is None or not fn_el.text:
                raise ValueError("VRT source missing SourceFilename")
            path = fn_el.text.strip()
            if fn_el.get("relativeToVRT", "0") == "1":
                if base_dir is None:
                    raise ValueError(
                        "VRT uses relativeToVRT sources but no base "
                        "directory is known (decode from a path, not "
                        "bare bytes)")
                from .. import storage
                path = storage.join(base_dir, path)
            if path not in cache:
                cache[path] = decode_image_bytes(open_fn(path))
            g = cache[path]
            sb = int(src_el.findtext("SourceBand", "1"))
            if not 1 <= sb <= g.array.shape[2]:
                raise ValueError(
                    f"VRT SourceBand {sb} out of range for {path} "
                    f"({g.array.shape[2]} bands)")
            sx, sy, sw, sh = _rect(src_el.find("SrcRect"),
                                   g.array.shape[1], g.array.shape[0])
            dx, dy, dw, dh = _rect(src_el.find("DstRect"),
                                   info.width, info.height)
            window = g.array[sy:sy + sh, sx:sx + sw, sb - 1]
            resampling = src_el.get("resampling", "nearest")
            if resampling != "nearest":
                raise ValueError(
                    f"VRT source resampling {resampling!r} not "
                    "supported (nearest only)")
            patch = _nearest(window, dh, dw).astype(np.float64)
            # NODATA masks SOURCE values, before ScaleRatio/ScaleOffset
            # are applied (GDAL's ComplexSource semantics) — a scaled
            # nodata pixel must stay nodata, and a valid pixel that
            # happens to scale TO the nodata value must survive
            src_nd = src_el.findtext("NODATA")
            keep = None if src_nd is None else patch != float(src_nd)
            ratio = float(src_el.findtext("ScaleRatio", "1"))
            offset = float(src_el.findtext("ScaleOffset", "0"))
            if ratio != 1.0 or offset != 0.0:
                patch = patch * ratio + offset
            dst = out[dy:dy + dh, dx:dx + dw, bi]
            if keep is not None:
                dst[keep] = patch[keep].astype(info.dtype)
            else:
                dst[:] = patch.astype(info.dtype)
    return GeoTIFF(out, info)


def sniff_vrt_info(data: bytes) -> RasterInfo:
    """Shape/geo from the XML alone (source files untouched)."""
    return _info_from_xml(_parse(data))
