"""CF-convention georeferencing shared by the scientific-format codecs.

A copy of the JAX package's ``raster/cf.py``. NetCDF rasters carry
georeferencing the CF way: 1-D coordinate variables along the x/y dims
plus an optional ``grid_mapping`` variable naming the projection; GDAL's
netCDF driver implements the same rules, which the reference reached
through rasterio (dl_segmentation_utils/_img_to_tf_mp.py:45-53).
"""

from __future__ import annotations

import re
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "is_x_coordinate", "is_y_coordinate",
    "geotransform_from_coords", "epsg_from_grid_mapping",
]

# CF identifies coordinate axes by standard_name / units / axis attrs
_X_STANDARD = {"projection_x_coordinate", "longitude", "grid_longitude"}
_Y_STANDARD = {"projection_y_coordinate", "latitude", "grid_latitude"}
_X_UNITS = {"degrees_east", "degree_east", "degrees_e", "degreee",
            "degreese"}
_Y_UNITS = {"degrees_north", "degree_north", "degrees_n", "degreen",
            "degreesn"}
_X_NAMES = {"x", "lon", "longitude", "easting", "xc"}
_Y_NAMES = {"y", "lat", "latitude", "northing", "yc"}


def _text(v) -> str:
    if isinstance(v, bytes):
        return v.decode("latin-1")
    if isinstance(v, np.ndarray) and v.dtype.kind in ("S", "U"):
        return "".join(x.decode("latin-1") if isinstance(x, bytes) else x
                       for x in v.ravel().tolist())
    return str(v)


def is_x_coordinate(name: str, attrs: Mapping) -> bool:
    sn = _text(attrs.get("standard_name", "")).lower()
    units = _text(attrs.get("units", "")).lower().replace(" ", "")
    axis = _text(attrs.get("axis", "")).upper()
    return (sn in _X_STANDARD or units in _X_UNITS or axis == "X"
            or name.lower() in _X_NAMES)


def is_y_coordinate(name: str, attrs: Mapping) -> bool:
    sn = _text(attrs.get("standard_name", "")).lower()
    units = _text(attrs.get("units", "")).lower().replace(" ", "")
    axis = _text(attrs.get("axis", "")).upper()
    return (sn in _Y_STANDARD or units in _Y_UNITS or axis == "Y"
            or name.lower() in _Y_NAMES)


def geotransform_from_coords(
        x: Optional[Sequence[float]], y: Optional[Sequence[float]],
) -> Optional[Tuple[float, float, float, float, float, float]]:
    """GDAL-style geotransform from 1-D CF coordinate arrays.

    CF coordinates are pixel CENTERS; a GDAL geotransform references
    the upper-left pixel CORNER, so origins shift by half a step
    (matching GDAL's netCDF driver). Requires both axes present,
    length >= 2, and even spacing (tolerance 1e-3 of the step —
    beyond that the grid is irregular and has no affine transform).
    """
    if x is None or y is None:
        return None
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.ndim != 1 or y.ndim != 1 or x.size < 2 or y.size < 2:
        return None
    dx = np.diff(x)
    dy = np.diff(y)
    if (abs(dx - dx[0]) > abs(dx[0]) * 1e-3 + 1e-12).any():
        return None
    if (abs(dy - dy[0]) > abs(dy[0]) * 1e-3 + 1e-12).any():
        return None
    sx = float(dx.mean())
    sy = float(dy.mean())
    return (float(x[0]) - sx / 2.0, sx, 0.0,
            float(y[0]) - sy / 2.0, 0.0, sy)


_EPSG_IN_WKT = re.compile(
    r'AUTHORITY\["EPSG",\s*"?(\d+)"?\]\s*\]\s*$', re.IGNORECASE)
_EPSG_ID_WKT2 = re.compile(
    r'ID\["EPSG",\s*(\d+)\]\s*\]\s*$', re.IGNORECASE)


def epsg_from_grid_mapping(attrs: Mapping) -> Tuple[Optional[int],
                                                    Optional[str]]:
    """(epsg, wkt) from a CF grid_mapping variable's attributes.

    Resolution order mirrors GDAL's netCDF driver: explicit WKT
    (``crs_wkt`` / ``spatial_ref``) wins, then ``epsg_code``, then the
    ``grid_mapping_name`` (latitude_longitude -> EPSG:4326;
    transverse_mercator with UTM-shaped parameters -> the UTM EPSG).
    """
    wkt = None
    for key in ("crs_wkt", "spatial_ref"):
        if key in attrs:
            wkt = _text(attrs[key])
            break
    if wkt:
        m = _EPSG_IN_WKT.search(wkt) or _EPSG_ID_WKT2.search(wkt)
        return (int(m.group(1)) if m else None), wkt
    code = attrs.get("epsg_code")
    if code is not None:
        m = re.search(r"(\d+)", _text(code))
        if m:
            return int(m.group(1)), None
    gm = _text(attrs.get("grid_mapping_name", "")).lower()
    if gm == "latitude_longitude":
        return 4326, None
    if gm == "transverse_mercator":
        def _f(key, default=None):
            v = attrs.get(key)
            if v is None:
                return default
            return float(np.asarray(v).ravel()[0])
        k0 = _f("scale_factor_at_central_meridian", 1.0)
        fe = _f("false_easting", 0.0)
        fn = _f("false_northing", 0.0)
        lon0 = _f("longitude_of_central_meridian")
        if (lon0 is not None and abs(k0 - 0.9996) < 1e-9
                and abs(fe - 500000.0) < 1e-6
                and (lon0 + 183.0) % 6.0 == 0.0):
            zone = int(round((lon0 + 183.0) / 6.0))
            if 1 <= zone <= 60:
                return (32600 + zone if fn == 0.0 else 32700 + zone), None
    return None, None
