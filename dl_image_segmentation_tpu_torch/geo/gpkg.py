"""GeoPackage (.gpkg) vector IO, stdlib-sqlite3 + hand-rolled WKB.

Extends the OGR-subset reader (geo/vector.py) with the modern default
interchange format. Implements the slice of the OGC GeoPackage spec
the label pipeline needs: feature tables registered in gpkg_contents /
gpkg_geometry_columns, the GP binary geometry header, and 2-D WKB
Polygon / MultiPolygon (+ Z/M variants by coordinate dropping).
Read only: the port's chip creation reads label layers and writes none.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import Optional

import numpy as np

from .geometry import Geometry

_WKB_POLYGON = 3
_WKB_MULTIPOLYGON = 6


# ---------------------------------------------------------------------------
# WKB
# ---------------------------------------------------------------------------

def _parse_wkb(buf: bytes, pos: int = 0):
    """Parse one WKB geometry; returns (Geometry, new_pos)."""
    bo = "<" if buf[pos] == 1 else ">"
    pos += 1
    (gtype,) = struct.unpack_from(bo + "I", buf, pos)
    pos += 4
    base = gtype % 1000
    ndim = 2 + (1 if gtype >= 1000 else 0) + (1 if gtype >= 2000 else 0)
    if gtype >= 3000:
        ndim = 4

    def read_ring():
        nonlocal pos
        (n,) = struct.unpack_from(bo + "I", buf, pos)
        pos += 4
        coords = np.frombuffer(buf, dtype=bo + "f8", count=n * ndim,
                               offset=pos).reshape(n, ndim)
        pos += n * ndim * 8
        return np.ascontiguousarray(coords[:, :2])

    def read_polygon_body():
        nonlocal pos
        (nrings,) = struct.unpack_from(bo + "I", buf, pos)
        pos += 4
        return [read_ring() for _ in range(nrings)]

    if base == _WKB_POLYGON:
        return Geometry([read_polygon_body()]), pos
    if base == _WKB_MULTIPOLYGON:
        (nparts,) = struct.unpack_from(bo + "I", buf, pos)
        pos += 4
        polys = []
        for _ in range(nparts):
            sub, pos = _parse_wkb(buf, pos)
            polys.extend(sub.polygons())
        return Geometry(polys), pos
    raise ValueError(f"unsupported WKB geometry type {gtype}")


# ---------------------------------------------------------------------------
# GPKG geometry blob (GP header + WKB)
# ---------------------------------------------------------------------------

def _parse_gpkg_geom(blob: bytes) -> Optional[Geometry]:
    if blob is None or len(blob) < 8 or blob[:2] != b"GP":
        return None
    flags = blob[3]
    if flags & 0x20:  # bit 5: extension (non-WKB) geometry encoding
        raise ValueError(
            "GeoPackage extension-encoded geometry (flags bit 5) is "
            "not supported; re-export with standard WKB encoding")
    envelope_code = (flags >> 1) & 0x7
    if envelope_code > 4:  # spec: codes 5-7 are invalid
        raise ValueError(
            f"invalid GeoPackage envelope contents code {envelope_code} "
            "(spec allows 0-4); corrupt header?")
    env_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}[envelope_code]
    wkb_off = 8 + env_len
    if flags & 0x10:  # bit 4: empty geometry (GeoPackage spec 2.1.3)
        return None
    geom, _ = _parse_wkb(blob, wkb_off)
    return geom


# ---------------------------------------------------------------------------
# dataset reader
# ---------------------------------------------------------------------------

def read_gpkg(path: str):
    """Read all feature layers of a GeoPackage. Returns the same
    VectorDataset shape as geo.vector.open_vector."""
    from .vector import Feature, VectorDataset, VectorLayer
    # sqlite3.connect would CREATE an empty file for a typo'd path and
    # then fail with an opaque "no such table: gpkg_contents" (leaving
    # the junk file to shadow the typo on the next open)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such GeoPackage: {path}")
    con = sqlite3.connect(path)
    con.row_factory = sqlite3.Row
    try:
        layers = []
        tables = con.execute(
            "SELECT c.table_name, c.srs_id, g.column_name FROM "
            "gpkg_contents c JOIN gpkg_geometry_columns g "
            "ON c.table_name = g.table_name "
            "WHERE c.data_type = 'features'").fetchall()
        for t in tables:
            name = t["table_name"]
            geom_col = t["column_name"]
            srs = int(t["srs_id"]) if t["srs_id"] is not None else 4326
            feats = []
            for row in con.execute(f'SELECT * FROM "{name}"'):
                props = {k: row[k] for k in row.keys()
                         if k != geom_col and not isinstance(row[k], bytes)}
                geom = _parse_gpkg_geom(row[geom_col])
                if geom is None or not geom.polygons():
                    continue
                feats.append(Feature(geom, props))
            layers.append(VectorLayer(name, feats,
                                      srs if srs > 0 else 4326))
        return VectorDataset(layers)
    finally:
        con.close()
