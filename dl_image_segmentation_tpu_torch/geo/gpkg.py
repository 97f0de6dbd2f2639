"""GeoPackage (.gpkg) vector IO, stdlib-sqlite3 + hand-rolled WKB.

A copy of the JAX package's ``geo/gpkg.py``. Extends the OGR-subset reader (geo/vector.py) with the modern default
interchange format. Implements the slice of the OGC GeoPackage spec
the label pipeline needs: feature tables registered in gpkg_contents /
gpkg_geometry_columns, the GP binary geometry header, and 2-D WKB
Polygon / MultiPolygon (+ Z/M variants by coordinate dropping).
Both read and write (write: enough of the spec that the reader and
common GIS tools accept the file; ``write_gpkg``'s files are byte for
byte the JAX package's, ``gpkg_contents.last_change`` aside).
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


def _encode_wkb(geom: Geometry) -> bytes:
    polys = geom.polygons()

    def poly_body(rings) -> bytes:
        out = struct.pack("<I", len(rings))
        for r in rings:
            r = np.asarray(r, dtype="<f8")
            if len(r) and not np.allclose(r[0], r[-1]):
                r = np.concatenate([r, r[:1]])
            out += struct.pack("<I", len(r)) + r.tobytes()
        return out

    if len(polys) == 1:
        return b"\x01" + struct.pack("<I", _WKB_POLYGON) \
            + poly_body(polys[0])
    out = b"\x01" + struct.pack("<I", _WKB_MULTIPOLYGON) \
        + struct.pack("<I", len(polys))
    for rings in polys:
        out += b"\x01" + struct.pack("<I", _WKB_POLYGON) + poly_body(rings)
    return out


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


def _encode_gpkg_geom(geom: Geometry, srs_id: int) -> bytes:
    # version 0, flags: little-endian byte order, no envelope
    header = b"GP\x00\x01" + struct.pack("<i", srs_id)
    return header + _encode_wkb(geom)


# ---------------------------------------------------------------------------
# dataset reader / writer
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


def write_gpkg(path: str, layer, srs_id: Optional[int] = None) -> None:
    """Write one VectorLayer to a new GeoPackage file."""
    if os.path.exists(path):
        os.remove(path)
    srs = srs_id if srs_id is not None else (layer.crs_epsg or 4326)
    con = sqlite3.connect(path)
    try:
        cur = con.cursor()
        cur.execute("PRAGMA application_id = 0x47504B47")  # 'GPKG'
        cur.execute("PRAGMA user_version = 10300")
        cur.execute(
            "CREATE TABLE gpkg_spatial_ref_sys (srs_name TEXT NOT NULL, "
            "srs_id INTEGER PRIMARY KEY, organization TEXT NOT NULL, "
            "organization_coordsys_id INTEGER NOT NULL, definition TEXT "
            "NOT NULL, description TEXT)")
        for sid, nm in ((-1, "Undefined cartesian"),
                        (0, "Undefined geographic"),
                        (4326, "WGS 84")):
            cur.execute("INSERT INTO gpkg_spatial_ref_sys VALUES "
                        "(?,?,?,?,?,NULL)",
                        (nm, sid, "EPSG" if sid > 0 else "NONE",
                         max(sid, 0), "undefined"))
        if srs not in (-1, 0, 4326):
            cur.execute("INSERT INTO gpkg_spatial_ref_sys VALUES "
                        "(?,?,?,?,?,NULL)",
                        (f"EPSG:{srs}", srs, "EPSG", srs, "undefined"))
        cur.execute(
            "CREATE TABLE gpkg_contents (table_name TEXT PRIMARY KEY, "
            "data_type TEXT NOT NULL, identifier TEXT UNIQUE, "
            "description TEXT DEFAULT '', last_change DATETIME, "
            "min_x DOUBLE, min_y DOUBLE, max_x DOUBLE, max_y DOUBLE, "
            "srs_id INTEGER)")
        cur.execute(
            "CREATE TABLE gpkg_geometry_columns (table_name TEXT NOT "
            "NULL, column_name TEXT NOT NULL, geometry_type_name TEXT "
            "NOT NULL, srs_id INTEGER NOT NULL, z TINYINT NOT NULL, "
            "m TINYINT NOT NULL, CONSTRAINT pk_geom_cols PRIMARY KEY "
            "(table_name, column_name))")
        # attribute columns from the first feature
        props0 = layer.features[0].properties if layer.features else {}
        cols = []
        for k, v in props0.items():
            sqltype = ("INTEGER" if isinstance(v, (int, bool))
                       else "REAL" if isinstance(v, float) else "TEXT")
            cols.append(f'"{k}" {sqltype}')
        col_sql = (", " + ", ".join(cols)) if cols else ""
        cur.execute(f'CREATE TABLE "{layer.name}" (fid INTEGER PRIMARY '
                    f'KEY AUTOINCREMENT, geom BLOB{col_sql})')
        keys = list(props0.keys())
        for f in layer.features:
            blob = _encode_gpkg_geom(f.geometry, srs)
            vals = [f.properties.get(k) for k in keys]
            ph = ",".join("?" * (1 + len(keys)))
            cur.execute(
                f'INSERT INTO "{layer.name}" (geom'
                + ("".join(f', "{k}"' for k in keys)) + f") VALUES ({ph})",
                [blob] + vals)
        bounds = None
        for f in layer.features:
            if f.geometry.is_empty:  # null shapes have no envelope
                continue
            b = f.geometry.bounds
            bounds = b if bounds is None else (
                min(bounds[0], b[0]), min(bounds[1], b[1]),
                max(bounds[2], b[2]), max(bounds[3], b[3]))
        cur.execute(
            "INSERT INTO gpkg_contents VALUES (?,?,?,?,"
            "datetime('now'),?,?,?,?,?)",
            (layer.name, "features", layer.name, "",
             *(bounds or (None,) * 4), srs))
        cur.execute("INSERT INTO gpkg_geometry_columns VALUES "
                    "(?,?,?,?,0,0)",
                    (layer.name, "geom", "MULTIPOLYGON", srs))
        con.commit()
    finally:
        con.close()
