"""Lightweight geometry model + exact polygon/rect predicates, pure numpy.

Replaces the reference's use of shapely/GEOS (via geopandas,
dl_segmentation_utils/_descartes_img_chips.py:400-428)
for the only operations the pipeline actually needs:

* coercing GeoJSON-like inputs (``__geo_interface__``) to coordinate arrays
* bounding boxes
* exact polygon-vs-axis-aligned-rectangle intersection (tile planning)
* point-in-polygon (even-odd rule; used by tests and the rasterizer's
  reference implementation)

Coordinates are numpy float64 arrays of shape (N, 2) per ring.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Sequence, Tuple

import numpy as np

Ring = np.ndarray  # (N, 2) float64, closed or open (we treat as closed)
PolygonRings = List[Ring]  # [exterior, hole1, hole2, ...]


class Geometry:
    """A minimal geometry: a list of polygons, each a list of rings.

    Supports Polygon, MultiPolygon, and (by ignoring non-area parts)
    GeometryCollection / Feature / FeatureCollection inputs.
    """

    def __init__(self, polygons: Sequence[PolygonRings]):
        self._polys: List[PolygonRings] = [
            [_ring2d(r) for r in rings] for rings in polygons
        ]

    # -- construction --------------------------------------------------
    @classmethod
    def coerce(cls, obj) -> "Geometry":
        if isinstance(obj, Geometry):
            return obj
        if hasattr(obj, "__geo_interface__"):
            obj = obj.__geo_interface__
        if not isinstance(obj, Mapping):
            raise TypeError(f"cannot coerce {type(obj)!r} to Geometry")
        return cls(list(_polygons_from_mapping(obj)))

    @property
    def __geo_interface__(self):
        if len(self._polys) == 1:
            return {
                "type": "Polygon",
                "coordinates": [r.tolist() for r in self._polys[0]],
            }
        return {
            "type": "MultiPolygon",
            "coordinates": [[r.tolist() for r in rings] for rings in self._polys],
        }

    # -- accessors ------------------------------------------------------
    def polygons(self) -> List[PolygonRings]:
        return self._polys

    @property
    def is_empty(self) -> bool:
        return not any(len(r) for rings in self._polys for r in rings)

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        rings = [r for rings in self._polys for r in rings if len(r)]
        if not rings:
            raise ValueError("empty geometry has no bounds (null shapes "
                             "from shapefiles reach here; check is_empty "
                             "before asking)")
        allc = np.concatenate(rings, axis=0)
        return (float(allc[:, 0].min()), float(allc[:, 1].min()),
                float(allc[:, 0].max()), float(allc[:, 1].max()))

    def explode(self) -> List["Geometry"]:
        """One Geometry per polygon part (reference: unary_union + explode,
        _descartes_img_chips.py:410; we skip the union -- tile dedup by
        key already removes the duplicates the union existed to avoid)."""
        return [Geometry([rings]) for rings in self._polys]


def _ring2d(r) -> np.ndarray:
    """Ring coordinates -> (N, 2) float64, dropping any z/m values.

    RFC 7946 allows [lon, lat, elev] positions; a blind reshape(-1, 2)
    on an (N, 3) array would interleave x/y/z into garbage coordinates
    instead of dropping the third axis."""
    arr = np.asarray(r, dtype=np.float64)
    if arr.size == 0:
        return arr.reshape(0, 2)
    if arr.ndim >= 2:
        arr = arr.reshape(-1, arr.shape[-1])
        if arr.shape[1] < 2:
            raise ValueError(
                f"ring positions need >=2 coordinates, got {arr.shape[1]}")
        return arr[:, :2]
    return arr.reshape(-1, 2)


def _polygons_from_mapping(obj: Mapping) -> Iterable[PolygonRings]:
    t = obj.get("type")
    if t == "FeatureCollection":
        for f in obj.get("features", []):
            yield from _polygons_from_mapping(f)
    elif t == "Feature":
        geom = obj.get("geometry")
        if geom:
            yield from _polygons_from_mapping(geom)
    elif t == "GeometryCollection":
        for g in obj.get("geometries", []):
            yield from _polygons_from_mapping(g)
    elif t == "Polygon":
        yield [_ring2d(r) for r in obj["coordinates"]]
    elif t == "MultiPolygon":
        for poly in obj["coordinates"]:
            yield [_ring2d(r) for r in poly]
    elif t in ("Point", "MultiPoint", "LineString", "MultiLineString"):
        # Non-area geometries contribute no coverage polygons; the
        # reference only rasterises polygons. Represent points as
        # degenerate tiny squares so "coverage at point locations"
        # (label_coverage_config use-case) still works.
        coords = np.asarray(obj["coordinates"], dtype=np.float64)
        pts = coords.reshape(-1, coords.shape[-1])[:, :2]
        eps = 1e-9
        for x, y in pts:
            sq = np.array([[x - eps, y - eps], [x + eps, y - eps],
                           [x + eps, y + eps], [x - eps, y + eps]])
            yield [sq]
    else:
        raise ValueError(f"unsupported geometry type: {t!r}")


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------

def bounds_of_coords(coords: np.ndarray) -> Tuple[float, float, float, float]:
    return (float(coords[:, 0].min()), float(coords[:, 1].min()),
            float(coords[:, 0].max()), float(coords[:, 1].max()))


def points_in_ring(px: np.ndarray, py: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Vectorised even-odd point-in-ring test. px/py: (M,), ring: (N,2)."""
    x0 = ring[:, 0]
    y0 = ring[:, 1]
    x1 = np.roll(x0, -1)
    y1 = np.roll(y0, -1)
    px = np.asarray(px, dtype=np.float64)[:, None]  # (M,1)
    py = np.asarray(py, dtype=np.float64)[:, None]
    # edge straddles the horizontal ray at py
    cond = (y0[None, :] > py) != (y1[None, :] > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x0[None, :] + (py - y0[None, :]) * (x1 - x0)[None, :] / (
            (y1 - y0)[None, :])
    crossings = cond & (px < xint)
    return (np.sum(crossings, axis=1) % 2).astype(bool)


def points_in_polygon(px, py, exterior: np.ndarray,
                      holes: Sequence[np.ndarray] = ()) -> np.ndarray:
    inside = points_in_ring(px, py, exterior)
    for h in holes:
        inside &= ~points_in_ring(px, py, h)
    return inside


def _segments_intersect_rect(ring: np.ndarray, x0, y0, x1, y1) -> bool:
    """True if any segment of the ring intersects the rectangle."""
    a = ring
    b = np.roll(ring, -1, axis=0)
    # quick reject: segment bbox vs rect
    sxmin = np.minimum(a[:, 0], b[:, 0])
    sxmax = np.maximum(a[:, 0], b[:, 0])
    symin = np.minimum(a[:, 1], b[:, 1])
    symax = np.maximum(a[:, 1], b[:, 1])
    cand = (sxmax >= x0) & (sxmin <= x1) & (symax >= y0) & (symin <= y1)
    if not np.any(cand):
        return False
    a = a[cand]
    b = b[cand]
    # endpoint inside rect
    for p in (a, b):
        if np.any((p[:, 0] >= x0) & (p[:, 0] <= x1) &
                  (p[:, 1] >= y0) & (p[:, 1] <= y1)):
            return True
    # Liang-Barsky style clipping test per segment
    d = b - a
    t0 = np.zeros(len(a))
    t1 = np.ones(len(a))
    ok = np.ones(len(a), dtype=bool)
    for (num_lo, num_hi, delta) in (
        (x0 - a[:, 0], x1 - a[:, 0], d[:, 0]),
        (y0 - a[:, 1], y1 - a[:, 1], d[:, 1]),
    ):
        par = delta == 0
        # parallel and outside the slab -> no intersection
        ok &= ~(par & ((num_lo > 0) | (num_hi < 0)))
        with np.errstate(divide="ignore", invalid="ignore"):
            tlo = np.where(par, -np.inf, num_lo / np.where(par, 1, delta))
            thi = np.where(par, np.inf, num_hi / np.where(par, 1, delta))
        lo = np.minimum(tlo, thi)
        hi = np.maximum(tlo, thi)
        t0 = np.maximum(t0, np.where(par, t0, lo))
        t1 = np.minimum(t1, np.where(par, t1, hi))
    return bool(np.any(ok & (t0 <= t1)))


def polygon_intersects_rect(exterior: np.ndarray,
                            holes: Sequence[np.ndarray],
                            x0: float, y0: float,
                            x1: float, y1: float) -> bool:
    """Exact polygon vs axis-aligned rectangle intersection test.

    True iff the polygon's area (exterior minus holes) overlaps the rect.
    """
    bx0, by0, bx1, by1 = bounds_of_coords(exterior)
    if bx1 < x0 or bx0 > x1 or by1 < y0 or by0 > y1:
        return False
    # any exterior or hole edge crossing the rect -> boundary overlap
    if _segments_intersect_rect(exterior, x0, y0, x1, y1):
        return True
    for h in holes:
        if _segments_intersect_rect(h, x0, y0, x1, y1):
            return True
    # no edge crossing: either rect fully inside polygon, polygon fully
    # inside rect, or disjoint. Test one rect corner against the polygon,
    # and one polygon vertex against the rect.
    cx = np.array([(x0 + x1) / 2.0])
    cy = np.array([(y0 + y1) / 2.0])
    if points_in_polygon(cx, cy, exterior, holes)[0]:
        return True
    vx, vy = exterior[0]
    if x0 <= vx <= x1 and y0 <= vy <= y1:
        # polygon vertex inside rect (polygon contained in rect)
        return True
    return False
