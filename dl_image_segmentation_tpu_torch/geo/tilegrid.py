"""Deterministic global tile grid, key-compatible with Descartes Labs DLTiles.

The reference obtains tiles from the remote Descartes Labs service
(`dl.scenes.DLTile.from_shape` / `.from_key`,
dl_segmentation_utils/_descartes_img_chips.py:389-425).
There is no DL server here, so the grid math is implemented locally and
deterministically.

Key format (observed in reference notebook keys such as
'252:2:1.0:43:-902:8394', create_training_samples.ipynb cell 56):

    "{tilesize}:{pad}:{resolution}:{zone}:{ti}:{tj}"

where tilesize is the UNPADDED pixel count, pad the per-side padding in
pixels, resolution the metres/pixel, zone the UTM zone, and (ti, tj) the
integer grid indices. Grid anchoring:

    easting_min  (unpadded) = 500000 + ti * tilesize * resolution
    northing_min (unpadded) = tj * tilesize * resolution

Northing is referenced to the equator and may be negative in the
southern hemisphere -- all INTERNAL grid math (``bounds``,
``geotrans_equator``) stays in this equator-referenced frame, keeping
keys hemisphere-agnostic and the grid globally continuous (tiles align
to the equator, so a tile never straddles it).

GEOREFERENCING outputs are hemisphere-aware, matching standard GIS
conventions (the reference got this via GDAL,
_descartes_img_chips.py:846-848): a tile south of the equator
(``tj < 0``) reports ``crs``/``epsg`` EPSG:327{zone} and a ``geotrans``
with the standard 10,000,000 m false northing applied, so the written
GeoTIFFs open correctly in external tools for both hemispheres.

Tiles expose the geocontext attributes the reference consumes:
``tilesize``, ``pad``, ``resolution``, ``wkt``, ``geotrans``, ``key``,
``bounds``, ``crs`` (see _descartes_img_chips.py:668-671, 840-848).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from . import crs as _crs
from .geometry import Geometry, bounds_of_coords, polygon_intersects_rect


def _fmt_res(resolution: float) -> str:
    """Format resolution the way DL keys do: 1.0, 10.0, 0.5 ..."""
    r = float(resolution)
    if r == int(r):
        return f"{r:.1f}"
    return repr(r)


@dataclass(frozen=True)
class Tile:
    """One tile of the global grid (DLTile equivalent).

    ``tilesize`` is the unpadded pixel count per side; the raster written
    for the tile is ``tilesize + 2*pad`` pixels square at ``resolution``
    metres/pixel.
    """

    tilesize: int
    pad: int
    resolution: float
    zone: int
    ti: int
    tj: int

    # -- key <-> tile ------------------------------------------------
    @property
    def key(self) -> str:
        return (f"{self.tilesize}:{self.pad}:{_fmt_res(self.resolution)}:"
                f"{self.zone}:{self.ti}:{self.tj}")

    @classmethod
    def from_key(cls, key: str) -> "Tile":
        parts = key.split(":")
        if len(parts) != 6:
            raise ValueError(f"not a tile key: {key!r}")
        ts, pad, res, zone, ti, tj = parts
        return cls(int(ts), int(pad), float(res), int(zone), int(ti), int(tj))

    # -- geometry ----------------------------------------------------
    @property
    def span_m(self) -> float:
        """Unpadded extent of the tile in metres."""
        return self.tilesize * self.resolution

    @property
    def bounds_unpadded(self) -> Tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax) in the tile's UTM CRS, without padding."""
        s = self.span_m
        x0 = _crs.UTM_FALSE_EASTING + self.ti * s
        y0 = self.tj * s
        return (x0, y0, x0 + s, y0 + s)

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax) in UTM including padding."""
        x0, y0, x1, y1 = self.bounds_unpadded
        p = self.pad * self.resolution
        return (x0 - p, y0 - p, x1 + p, y1 + p)

    @property
    def raster_size(self) -> int:
        """Pixels per side of the padded raster."""
        return self.tilesize + 2 * self.pad

    # -- hemisphere-aware georeferencing ------------------------------
    @property
    def north(self) -> bool:
        """True for tiles in the northern hemisphere. Tiles align to
        the equator (northing 0 is a tile boundary), so tj >= 0 means
        the whole unpadded tile is at-or-north of the equator."""
        return self.tj >= 0

    @property
    def epsg(self) -> int:
        return (32600 if self.north else 32700) + self.zone

    @property
    def false_northing(self) -> float:
        """Northing offset between the tile's reported CRS and the
        grid's internal equator-referenced frame (10^7 m for southern
        tiles, per standard UTM-south convention)."""
        return 0.0 if self.north else 10_000_000.0

    @property
    def geotrans(self) -> Tuple[float, float, float, float, float, float]:
        """GDAL-style geotransform of the PADDED raster in the tile's
        reported CRS (``self.crs``): (origin_x, px_w, 0, origin_y, 0,
        -px_h). Origin is the top-left corner; row 0 is the
        northernmost row. Southern tiles carry the UTM-south false
        northing -- use ``geotrans_equator`` for grid-internal math."""
        x0, _, _, y1 = self.bounds
        r = self.resolution
        return (x0, r, 0.0, y1 + self.false_northing, 0.0, -r)

    @property
    def geotrans_equator(self) -> Tuple[float, float, float, float,
                                        float, float]:
        """Geotransform in the internal equator-referenced frame
        (negative northings south of the equator), matching
        ``bounds`` and geo.crs.lonlat_to_utm."""
        x0, _, _, y1 = self.bounds
        r = self.resolution
        return (x0, r, 0.0, y1, 0.0, -r)

    @property
    def wkt(self) -> str:
        return _crs.utm_wkt(self.zone, north=self.north)

    @property
    def crs(self) -> str:
        return f"EPSG:{self.epsg}"

    @property
    def lonlat_bounds(self) -> Tuple[float, float, float, float]:
        """Approximate WGS84 bounds of the padded tile (via its corners)."""
        x0, y0, x1, y1 = self.bounds
        xs = np.array([x0, x1, x0, x1])
        ys = np.array([y0, y0, y1, y1])
        lon, lat = _crs.utm_to_lonlat(xs, ys, self.zone)
        return (float(lon.min()), float(lat.min()),
                float(lon.max()), float(lat.max()))

    @property
    def center_lonlat(self) -> Tuple[float, float]:
        x0, y0, x1, y1 = self.bounds_unpadded
        lon, lat = _crs.utm_to_lonlat((x0 + x1) / 2, (y0 + y1) / 2, self.zone)
        return float(lon), float(lat)

    # -- filename contract (README.md:14-15, _descartes_img_chips.py:749)
    @property
    def filename(self) -> str:
        return self.key.replace(":", "#")

    @classmethod
    def from_filename(cls, name: str) -> "Tile":
        # basename, strip extension(s), then '#' -> ':' (reference
        # convention: _img_to_tf_mp.py:60-62)
        base = name.rsplit("/", 1)[-1]
        # strip only the LAST extension, like the reference's
        # '.'.join(basename.split(os.extsep)[:-1]) -- the key itself
        # contains '.' in the resolution field (e.g. '1.0')
        stem = base.rsplit(".", 1)[0] if "." in base else base
        try:
            return cls.from_key(stem.replace("#", ":"))
        except ValueError:
            # extension-less filename whose only '.' is the resolution's
            return cls.from_key(base.replace("#", ":"))


def tile_from_key(key: str) -> Tile:
    return Tile.from_key(key)


def tiles_to_layer(tiles: Sequence["Tile"]):
    """Persistable vector layer of tile footprints (WGS84 polygons with
    a 'key' attribute) -- the reference's save-tile-list-to-shapefile
    resume flow (create nb cells 22-24) via geo.vector.write_geojson;
    reload with DLSampleCreationConfig.get_tiles(tile_ids=[...keys])."""
    from .vector import Feature, VectorLayer
    from .geometry import Geometry
    feats = []
    for t in tiles:
        x0, y0, x1, y1 = t.bounds_unpadded
        xs = np.array([x0, x1, x1, x0, x0])
        ys = np.array([y0, y0, y1, y1, y0])
        lon, lat = _crs.utm_to_lonlat(xs, ys, t.zone)
        ring = np.stack([lon, lat], axis=1)
        feats.append(Feature(Geometry([[ring]]), {"key": t.key}))
    return VectorLayer("tiles", feats, 4326)


def tiles_from_bounds_utm(
    bounds: Tuple[float, float, float, float],
    zone: int,
    resolution: float,
    tilesize: int,
    pad: int,
) -> Iterator[Tile]:
    """All tiles whose UNPADDED extent intersects the UTM bounds."""
    xmin, ymin, xmax, ymax = bounds
    s = tilesize * resolution
    ti0 = math.floor((xmin - _crs.UTM_FALSE_EASTING) / s)
    ti1 = math.floor((xmax - _crs.UTM_FALSE_EASTING) / s)
    tj0 = math.floor(ymin / s)
    tj1 = math.floor(ymax / s)
    for ti in range(ti0, ti1 + 1):
        for tj in range(tj0, tj1 + 1):
            yield Tile(tilesize, pad, float(resolution), zone, ti, tj)


def tiles_from_shape(
    shape,
    resolution: float,
    tilesize: int,
    pad: int,
) -> List[Tile]:
    """Covering tiles for a WGS84 geometry (DLTile.from_shape equivalent,
    _descartes_img_chips.py:421-425).

    ``shape`` may be a Geometry, a GeoJSON-like mapping, or anything with
    ``__geo_interface__``. Geometries spanning multiple UTM zones are
    split automatically (the DL service did this server-side): every
    overlapped zone contributes the tiles of ITS grid whose longitude
    range overlaps that zone's 6-degree band, so the union always
    covers the AOI (a centre-based assignment was found to leave
    boundary slivers uncovered when tiles from both grids hang across
    the seam in opposite directions); tiles straddling the seam may
    appear from both zones' grids, giving slight double coverage there
    rather than gaps. Single-zone AOIs use the bbox centre's zone,
    tiles overhanging the zone edge included (unchanged pre-split
    behavior). AOIs touching the antimeridian work when split into
    parts per the GeoJSON spec (RFC 7946 3.1.9): zone spans are
    computed per polygon part, so a Fiji-style MultiPolygon touches
    zones {60, 1} instead of enumerating all 60, while a genuinely
    wide part (lon -100..100) covers every zone in between.

    Returns tiles whose unpadded extent intersects the geometry (exact
    polygon-rectangle test, not just bbox).
    """
    geom = Geometry.coerce(shape)

    # Candidate zones are computed PER POLYGON PART, and a part is only
    # ever projected into zones its own longitude span touches:
    # projecting geometry into a zone half a world away both diverges
    # the transverse-Mercator series and blows the projected bbox up to
    # an astronomically large tile enumeration. Raw longitude spans are
    # taken at face value: per the GeoJSON spec (RFC 7946 section
    # 3.1.9) antimeridian-crossing geometries are SPLIT into parts, so
    # a Fiji-style AOI arrives as parts near +180 and -180 and touches
    # zones {60, 1} -- while a genuinely wide part (lon -100..100)
    # correctly touches every zone in between (no wrap guessing, which
    # would compute the COMPLEMENT of the right zone set for wide
    # AOIs).
    def _zone_lon_band(zone: int, lat: float):
        """Effective [lon0, lon1) ownership band of ``zone`` at ``lat``,
        or None where the zone is unused -- the inverse of
        crs.utm_zone_from_lonlat's Norway/Svalbard exceptions. Using
        the NOMINAL 6-degree band here silently dropped coverage:
        e.g. a part at lon 3..6, lat 56..64 is assigned zone 32, whose
        nominal band (6..12) doesn't contain it, so the bbox clamp and
        the longitude filter both rejected every tile."""
        lon0 = (zone - 1) * 6.0 - 180.0
        lon1 = lon0 + 6.0
        if 56.0 <= lat < 64.0:  # Norway (32V)
            if zone == 31:
                lon1 = 3.0
            elif zone == 32:
                lon0 = 3.0
        elif 72.0 <= lat < 84.0:  # Svalbard (31X..37X)
            if zone == 31:
                lon1 = 9.0
            elif zone == 33:
                lon0, lon1 = 9.0, 21.0
            elif zone == 35:
                lon0, lon1 = 21.0, 33.0
            elif zone == 37:
                lon0, lon1 = 33.0, 42.0
            elif zone in (32, 34, 36):
                return None
        return lon0, lon1

    def _part_zones(lons: np.ndarray, lat_mid: float) -> List[int]:
        lo, hi = float(lons.min()), float(lons.max())
        z_lo = int(_crs.utm_zone_from_lonlat(lo, lat_mid))
        z_hi = int(_crs.utm_zone_from_lonlat(min(hi, 179.999999),
                                             lat_mid))
        if z_lo <= z_hi:
            return list(range(z_lo, z_hi + 1))
        return list(range(z_lo, 61)) + list(range(1, z_hi + 1))

    def _lat_samples(lat_lo: float, lat_hi: float) -> List[float]:
        """Latitudes at which zone ownership can change across a part:
        the extremes, plus representatives of every exception regime
        the range intersects (Norway 56..64, Svalbard 72..84) and the
        regime boundaries themselves."""
        ls = [lat_lo, lat_hi]
        for b in (56.0, 64.0, 72.0, 84.0):
            if lat_lo < b < lat_hi:
                ls.append(b)
                ls.append(b - 1e-6)
        if lat_lo < 60.0 < lat_hi or (56.0 <= lat_lo < 64.0):
            ls.append(min(max(58.0, lat_lo), lat_hi))
        if lat_lo < 78.0 < lat_hi or (72.0 <= lat_lo < 84.0):
            ls.append(min(max(78.0, lat_lo), lat_hi))
        return sorted(set(ls))

    parts = []
    all_zones: set = set()
    for ring_set in geom.polygons():  # (exterior, holes) in lonlat
        exterior = ring_set[0]
        lat_lo = float(exterior[:, 1].min())
        lat_hi = float(exterior[:, 1].max())
        # union over the regime-aware latitude samples: a part whose
        # lat span crosses 56/72 can touch exception zones (e.g. 32 at
        # lon 3..6) that its mid-latitude alone would never name
        zs: List[int] = []
        for lat_s in _lat_samples(lat_lo, lat_hi):
            for z in _part_zones(exterior[:, 0], lat_s):
                if z not in zs:
                    zs.append(z)
        parts.append((ring_set, zs))
        all_zones.update(zs)
    multi_zone = len(all_zones) > 1

    out: List[Tile] = []
    for ring_set, zones in parts:
        exterior = ring_set[0]
        lats = exterior[:, 1]
        for zone in zones:
            # a tile survives in a zone when its longitude range
            # overlaps that zone's effective band (only enforced when
            # the AOI spans multiple zones)
            ex, ey = _crs.lonlat_to_utm(exterior[:, 0], exterior[:, 1],
                                        zone)
            poly_utm = np.stack([ex, ey], axis=1)
            holes_utm = []
            for hole in ring_set[1:]:
                hx, hy = _crs.lonlat_to_utm(hole[:, 0], hole[:, 1], zone)
                holes_utm.append(np.stack([hx, hy], axis=1))
            bb = bounds_of_coords(poly_utm)
            if multi_zone:
                # clamp enumeration to this zone's EFFECTIVE band (one
                # padded-tile margin): only band tiles survive the
                # longitude filter below, and a wide part would
                # otherwise enumerate its full width in EVERY zone.
                # The band follows the Norway/Svalbard exceptions per
                # sampled latitude; a zone unused across the part's
                # whole latitude range contributes nothing.
                lat_samples = _lat_samples(float(lats.min()),
                                           float(lats.max()))
                if lat_samples[0] < 0.0 < lat_samples[-1]:
                    lat_samples.append(0.0)  # widest easting at equator
                edges = []
                for lat_s in lat_samples:
                    band = _zone_lon_band(zone, lat_s)
                    if band is None:
                        continue
                    for lon_edge in band:
                        e_edge, _ = _crs.lonlat_to_utm(lon_edge, lat_s,
                                                       zone)
                        edges.append(float(e_edge))
                if not edges:
                    continue
                margin = (tilesize + 2 * pad) * resolution
                bb = (max(bb[0], min(edges) - margin), bb[1],
                      min(bb[2], max(edges) + margin), bb[3])
                if bb[0] > bb[2]:
                    continue
            for tile in tiles_from_bounds_utm(bb, zone, resolution,
                                              tilesize, pad):
                x0, y0, x1, y1 = tile.bounds_unpadded
                if not polygon_intersects_rect(poly_utm, holes_utm,
                                               x0, y0, x1, y1):
                    continue
                if multi_zone:
                    (t_lon_min, t_lat_min,
                     t_lon_max, t_lat_max) = tile.lonlat_bounds
                    keep = False
                    for lat_s in (t_lat_min,
                                  0.5 * (t_lat_min + t_lat_max),
                                  t_lat_max):
                        band = _zone_lon_band(zone, lat_s)
                        if (band is not None and t_lon_max > band[0]
                                and t_lon_min < band[1]):
                            keep = True
                            break
                    if not keep:
                        continue
                out.append(tile)
    # dedup preserving order (same client-side key-set pattern as
    # _descartes_img_chips.py:448-457)
    seen = set()
    uniq = []
    for t in out:
        if t.key not in seen:
            seen.add(t.key)
            uniq.append(t)
    return uniq
