"""Vector dataset reader and writers: GeoJSON and ESRI Shapefile, pure
Python.

Replaces the OGR subset the reference actually uses
(dl_segmentation_utils/_descartes_img_chips.py:125-144,
633-689): open a dataset, enumerate layers, iterate features with an
integer attribute, in some CRS. Supported formats:

* GeoJSON / newline-less .json/.geojson (one layer, named after the file)
* ESRI Shapefile (.shp + .dbf [+ .prj]) -- polygon/multipolygon types

A dataset exposes ``layers()`` -> [VectorLayer]; each layer exposes
``features`` (list of Feature), ``crs_wkt``/``crs_epsg`` and ``name``.
CRS handling matches the pipeline's needs: features can be reprojected
to WGS84 or to a UTM zone via geo.crs. ``write_geojson`` and
``write_shapefile`` (.shp, .shx, .dbf, .prj) write a polygon layer.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .geometry import Geometry
from . import crs as _crs


@dataclass
class Feature:
    geometry: Geometry
    properties: Dict[str, object] = field(default_factory=dict)


@dataclass
class VectorLayer:
    name: str
    features: List[Feature]
    crs_epsg: Optional[int] = 4326  # GeoJSON default per RFC 7946

    def to_wgs84(self) -> "VectorLayer":
        """Reproject features to EPSG:4326 (replaces gdf.to_crs,
        _descartes_img_chips.py:350)."""
        if self.crs_epsg in (None, 4326):
            return self
        epsg = self.crs_epsg
        if 32601 <= epsg <= 32660:
            zone, north = epsg - 32600, True
        elif 32701 <= epsg <= 32760:
            zone, north = epsg - 32700, False
        else:
            raise ValueError(f"unsupported source CRS EPSG:{epsg}; "
                             "only WGS84 and UTM are implemented")
        fn = 0.0 if north else 10000000.0
        out = []
        for f in self.features:
            polys = []
            for rings in f.geometry.polygons():
                new_rings = []
                for r in rings:
                    lon, lat = _crs.tm_to_lonlat(
                        r[:, 0], r[:, 1],
                        _crs.zone_central_meridian_deg(zone),
                        false_northing=fn)
                    new_rings.append(np.stack([lon, lat], axis=1))
                polys.append(new_rings)
            out.append(Feature(Geometry(polys), dict(f.properties)))
        return VectorLayer(self.name, out, 4326)


class VectorDataset:
    """An opened vector dataset: one or more named layers."""

    def __init__(self, layers: List[VectorLayer]):
        self._layers = layers

    def layers(self) -> List[VectorLayer]:
        return self._layers

    def layer_names(self) -> List[str]:
        return [l.name for l in self._layers]

    def get_layer(self, name_or_idx) -> VectorLayer:
        if isinstance(name_or_idx, int):
            return self._layers[name_or_idx]
        for l in self._layers:
            if l.name == name_or_idx:
                return l
        raise KeyError(name_or_idx)

    def get_layer_index(self, name_or_idx) -> int:
        """Index of a layer by name, -1 if absent (mirrors
        OGRLabelDataDesc.get_layer_index, _descartes_img_chips.py:125-144)."""
        if isinstance(name_or_idx, int):
            return name_or_idx
        for i, l in enumerate(self._layers):
            if l.name == name_or_idx:
                return i
        return -1


def open_vector(path: str) -> VectorDataset:
    """Open a GeoJSON, Shapefile, or GeoPackage dataset."""
    low = path.lower()
    if low.endswith((".json", ".geojson")):
        return _open_geojson(path)
    if low.endswith(".shp"):
        return _open_shapefile(path)
    if low.endswith(".gpkg"):
        from .gpkg import read_gpkg
        return read_gpkg(path)
    # directory of shapefiles = multi-layer dataset (file-GDB stand-in)
    if os.path.isdir(path):
        layers = []
        for fn in sorted(os.listdir(path)):
            if fn.lower().endswith(".shp"):
                layers.extend(_open_shapefile(os.path.join(path, fn)).layers())
            elif fn.lower().endswith((".json", ".geojson")):
                layers.extend(_open_geojson(os.path.join(path, fn)).layers())
        if layers:
            return VectorDataset(layers)
    raise ValueError(f"unsupported vector dataset: {path}")


# ---------------------------------------------------------------------------
# GeoJSON
# ---------------------------------------------------------------------------

def _open_geojson(path: str) -> VectorDataset:
    with open(path, "r", encoding="utf-8") as f:
        obj = json.load(f)
    name = os.path.splitext(os.path.basename(path))[0]
    feats: List[Feature] = []
    crs_epsg = 4326
    # legacy "crs" member support (e.g. urn:ogc:def:crs:EPSG::32643)
    crs_member = obj.get("crs") if isinstance(obj, dict) else None
    if crs_member:
        nm = crs_member.get("properties", {}).get("name", "")
        for tok in str(nm).replace("::", ":").split(":"):
            if tok.isdigit():
                crs_epsg = int(tok)
    if obj.get("type") == "FeatureCollection":
        for f in obj.get("features", []):
            geom = f.get("geometry")
            if geom is None:
                continue
            try:
                g = Geometry.coerce(geom)
            except ValueError:
                continue
            feats.append(Feature(g, f.get("properties") or {}))
    else:
        feats.append(Feature(Geometry.coerce(obj), {}))
    return VectorDataset([VectorLayer(name, feats, crs_epsg)])


# ---------------------------------------------------------------------------
# ESRI Shapefile (.shp/.dbf/.prj) -- polygons only
# ---------------------------------------------------------------------------

_SHP_POLYGON = 5
_SHP_POLYGONZ = 15
_SHP_POLYGONM = 25


def _open_shapefile(path: str) -> VectorDataset:
    name = os.path.splitext(os.path.basename(path))[0]
    geoms = _read_shp(path)
    dbf_path = os.path.splitext(path)[0] + ".dbf"
    if os.path.exists(dbf_path):
        props = _read_dbf(dbf_path)
        if len(props) < len(geoms):
            # fewer .dbf rows than geometries would silently shift
            # every later attribute onto the wrong geometry via zip
            raise ValueError(
                f"{dbf_path}: {len(props)} attribute rows for "
                f"{len(geoms)} geometries -- corrupt sidecar")
        # props[i] is None for soft-deleted records: drop geometry i
        # with it (OGR's behaviour), keeping all later rows aligned
        feats = [Feature(g, p)
                 for g, p in zip(geoms, props) if p is not None]
    else:
        feats = [Feature(g, {}) for g in geoms]
    crs_epsg = 4326
    prj_path = os.path.splitext(path)[0] + ".prj"
    if os.path.exists(prj_path):
        with open(prj_path, "r", encoding="utf-8", errors="replace") as f:
            crs_epsg = _epsg_from_wkt(f.read()) or 4326
    return VectorDataset([VectorLayer(name, feats, crs_epsg)])


def _epsg_from_wkt(wkt: str) -> Optional[int]:
    # last AUTHORITY["EPSG","xxxxx"] wins (the PROJCS-level one)
    idx = wkt.rfind('AUTHORITY["EPSG"')
    if idx < 0:
        # try to recognise UTM by name
        if "UTM zone" in wkt:
            import re
            m = re.search(r"UTM zone (\d+)([NS])", wkt)
            if m:
                z = int(m.group(1))
                return (32600 if m.group(2) == "N" else 32700) + z
        if "GCS_WGS_1984" in wkt or "WGS 84" in wkt or "WGS_1984" in wkt:
            return 4326
        return None
    rest = wkt[idx:]
    num = ""
    for ch in rest.split(",", 1)[1]:
        if ch.isdigit():
            num += ch
        elif num:
            break
    return int(num) if num else None


def _read_shp(path: str) -> List[Geometry]:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 100:
        raise ValueError("truncated shapefile")
    (code,) = struct.unpack(">i", data[:4])
    if code != 9994:
        raise ValueError("not a shapefile")
    (shp_type,) = struct.unpack("<i", data[32:36])
    geoms: List[Geometry] = []
    off = 100
    n = len(data)
    while off + 8 <= n:
        (_recno, content_len) = struct.unpack(">ii", data[off:off + 8])
        off += 8
        rec = data[off:off + content_len * 2]
        off += content_len * 2
        if len(rec) < 4:
            break
        (rtype,) = struct.unpack("<i", rec[:4])
        if rtype == 0:  # null shape
            geoms.append(Geometry([]))
            continue
        if rtype not in (_SHP_POLYGON, _SHP_POLYGONZ, _SHP_POLYGONM):
            raise ValueError(f"unsupported shapefile record type {rtype}")
        # header: bbox (4 doubles), numParts, numPoints
        num_parts, num_points = struct.unpack("<ii", rec[36:44])
        parts = np.frombuffer(rec, dtype="<i4", count=num_parts, offset=44)
        pts_off = 44 + 4 * num_parts
        pts = np.frombuffer(rec, dtype="<f8",
                            count=num_points * 2, offset=pts_off)
        pts = pts.reshape(num_points, 2)
        ring_bounds = list(parts) + [num_points]
        rings = [pts[ring_bounds[i]:ring_bounds[i + 1]].copy()
                 for i in range(num_parts)]
        # group rings into polygons: CW (negative signed area in
        # y-up coords) = exterior per shapefile spec; CCW = hole
        polys: List[List[np.ndarray]] = []
        holes: List[np.ndarray] = []
        for r in rings:
            if _signed_area(r) < 0:  # exterior (clockwise)
                polys.append([r])
            else:
                holes.append(r)
        if not polys and holes:
            # tolerate wrong winding: treat all as exteriors
            polys = [[h] for h in holes]
            holes = []
        for h in holes:
            # assign hole to the first polygon whose bbox contains it
            hx, hy = h[0]
            placed = False
            for p in polys:
                ex = p[0]
                if (ex[:, 0].min() <= hx <= ex[:, 0].max()
                        and ex[:, 1].min() <= hy <= ex[:, 1].max()):
                    p.append(h)
                    placed = True
                    break
            if not placed and polys:
                polys[0].append(h)
        geoms.append(Geometry(polys))
    return geoms


def _signed_area(ring: np.ndarray) -> float:
    x = ring[:, 0]
    y = ring[:, 1]
    return float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y) / 2.0)


def _read_dbf(path: str) -> List[Optional[Dict[str, object]]]:
    """Attribute rows by record index; None marks a soft-deleted
    record (caller drops its geometry too, preserving alignment)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 32:
        return []
    num_rec, hdr_size, rec_size = struct.unpack("<IHH", data[4:12])
    fields = []
    off = 32
    while off < hdr_size - 1 and data[off] != 0x0D:
        fd = data[off:off + 32]
        fname = fd[:11].split(b"\x00")[0].decode("ascii", errors="replace")
        ftype = chr(fd[11])
        flen = fd[16]
        fdec = fd[17]
        fields.append((fname, ftype, flen, fdec))
        off += 32
    out: List[Dict[str, object]] = []
    off = hdr_size
    for _ in range(num_rec):
        if off + rec_size > len(data):
            break
        rec = data[off:off + rec_size]
        off += rec_size
        if rec[:1] == b"*":  # deleted: keep a placeholder so row i
            out.append(None)  # still pairs with geometry i (caller
            continue          # drops the pair together, like OGR)
        props: Dict[str, object] = {}
        p = 1
        for fname, ftype, flen, fdec in fields:
            raw = rec[p:p + flen]
            p += flen
            txt = raw.decode("latin-1").strip()
            if ftype in ("N", "F"):
                if not txt:
                    props[fname] = None
                elif fdec or ("." in txt):
                    try:
                        props[fname] = float(txt)
                    except ValueError:
                        props[fname] = None
                else:
                    try:
                        props[fname] = int(txt)
                    except ValueError:
                        props[fname] = None
            elif ftype == "L":
                props[fname] = txt.upper() in ("T", "Y")
            else:
                props[fname] = txt
        out.append(props)
    return out


# ---------------------------------------------------------------------------
# writers (persist tile plans: the reference's save-tile-list-to-shapefile
# resume flow, create nb cells 22-24); byte for byte the JAX package's
# ---------------------------------------------------------------------------

_WGS84_WKT = ('GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",'
              '6378137,298.257223563]],PRIMEM["Greenwich",0],'
              'UNIT["degree",0.0174532925199433],'
              'AUTHORITY["EPSG","4326"]]')


def _ensure_winding(ring: np.ndarray, clockwise: bool) -> np.ndarray:
    """The ring closed and in the given winding (shoelace sign)."""
    r = np.asarray(ring, dtype=np.float64)
    if len(r) and not np.allclose(r[0], r[-1]):
        r = np.concatenate([r, r[:1]])
    area2 = float(np.sum(r[:-1, 0] * r[1:, 1] - r[1:, 0] * r[:-1, 1]))
    is_ccw = area2 > 0
    if is_ccw == clockwise:
        r = r[::-1].copy()
    return r


def write_shapefile(path: str, layer: VectorLayer) -> None:
    """Write a polygon layer as an ESRI Shapefile (.shp/.shx/.dbf/.prj).

    Exterior rings are written clockwise and holes counter-clockwise
    per the spec; attributes come from the first feature's properties
    (ints/floats -> N fields, everything else -> C fields)."""
    base = os.path.splitext(path)[0]

    records = []
    for f in layer.features:
        rings = []
        for poly in f.geometry.polygons():
            if not poly:
                continue
            rings.append(_ensure_winding(poly[0], clockwise=True))
            for hole in poly[1:]:
                rings.append(_ensure_winding(hole, clockwise=False))
        records.append(rings)

    body = bytearray()
    offsets = []
    for recno, rings in enumerate(records, start=1):
        pts = (np.concatenate(rings, axis=0) if rings
               else np.zeros((0, 2)))
        content = struct.pack("<i", 5 if rings else 0)
        if rings:
            content += struct.pack(
                "<4d", pts[:, 0].min(), pts[:, 1].min(),
                pts[:, 0].max(), pts[:, 1].max())
            content += struct.pack("<ii", len(rings), len(pts))
            idx = 0
            for r in rings:
                content += struct.pack("<i", idx)
                idx += len(r)
            content += np.ascontiguousarray(pts, "<f8").tobytes()
        offsets.append((100 + len(body)) // 2)
        body += struct.pack(">ii", recno, len(content) // 2) + content

    allpts = [np.concatenate(r, axis=0) for r in records if r]
    if allpts:
        ap = np.concatenate(allpts, axis=0)
        bbox = (ap[:, 0].min(), ap[:, 1].min(),
                ap[:, 0].max(), ap[:, 1].max())
    else:
        bbox = (0.0, 0.0, 0.0, 0.0)

    def header(total_words: int) -> bytes:
        h = struct.pack(">i", 9994) + b"\x00" * 20
        h += struct.pack(">i", total_words)
        h += struct.pack("<ii", 1000, 5)
        h += struct.pack("<4d", *bbox)
        h += struct.pack("<4d", 0, 0, 0, 0)
        return h

    with open(base + ".shp", "wb") as fh:
        fh.write(header((100 + len(body)) // 2))
        fh.write(body)
    shx_body = b"".join(
        struct.pack(">ii", off,
                    struct.unpack(">i", body[(off * 2 - 100) + 4:
                                             (off * 2 - 100) + 8])[0])
        for off in offsets)
    with open(base + ".shx", "wb") as fh:
        fh.write(header((100 + len(shx_body)) // 2))
        fh.write(shx_body)

    # DBF: infer fields from the first feature
    props0 = layer.features[0].properties if layer.features else {}
    # DBF names are 10-char-truncated; values must still be looked up
    # by the ORIGINAL property key or long-named fields come out blank
    # (C) or crash on int('') (N)
    fields = []
    for k, v in props0.items():
        nm = str(k)[:10]
        if isinstance(v, bool) or isinstance(v, int):
            fields.append((nm, k, "N", 18, 0))
        elif isinstance(v, float):
            fields.append((nm, k, "N", 18, 6))
        else:
            fields.append((nm, k, "C", 80, 0))
    if not fields:
        fields = [("FID", "FID", "N", 18, 0)]
    rec_size = 1 + sum(f[3] for f in fields)
    hdr_size = 32 + 32 * len(fields) + 1
    dbf = bytearray()
    dbf += struct.pack("<BBBBIHH", 3, 24, 1, 1, len(layer.features),
                       hdr_size, rec_size)
    dbf += b"\x00" * 20
    for nm, _key, t, ln, dec in fields:
        dbf += nm.encode("ascii", "replace").ljust(11, b"\x00")
        dbf += t.encode() + b"\x00" * 4 + bytes([ln, dec]) + b"\x00" * 14
    dbf += b"\x0d"
    for i, f in enumerate(layer.features):
        dbf += b" "
        for nm, key, t, ln, dec in fields:
            v = f.properties.get(key, i if nm == "FID" else "")
            if t == "N":
                txt = ("" if v is None or v == "" else
                       (f"{float(v):.{dec}f}" if dec else str(int(v))))
                dbf += txt.rjust(ln)[:ln].encode("ascii", "replace")
            else:
                dbf += str(v).ljust(ln)[:ln].encode("latin-1", "replace")
    dbf += b"\x1a"
    with open(base + ".dbf", "wb") as fh:
        fh.write(bytes(dbf))

    epsg = layer.crs_epsg or 4326
    if 32601 <= epsg <= 32660:
        wkt = _crs.utm_wkt(epsg - 32600, north=True)
    elif 32701 <= epsg <= 32760:
        wkt = _crs.utm_wkt(epsg - 32700, north=False)
    else:
        wkt = _WGS84_WKT
    with open(base + ".prj", "w", encoding="ascii") as fh:
        fh.write(wkt)


def write_geojson(path: str, layer: VectorLayer) -> None:
    """Write a layer as a GeoJSON FeatureCollection (a ``crs`` member
    names a CRS other than WGS84)."""
    feats = []
    for f in layer.features:
        feats.append({
            "type": "Feature",
            "geometry": f.geometry.__geo_interface__,
            "properties": f.properties,
        })
    obj = {"type": "FeatureCollection", "features": feats}
    if layer.crs_epsg and layer.crs_epsg != 4326:
        obj["crs"] = {"type": "name", "properties": {
            "name": f"urn:ogc:def:crs:EPSG::{layer.crs_epsg}"}}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
