"""WGS84 <-> UTM transverse-Mercator projection math, pure numpy.

The reference delegates all reprojection to PROJ via geopandas
(dl_segmentation_utils/_descartes_img_chips.py:342-351).
This environment has no PROJ, so we implement the exact transverse
Mercator projection directly using Karney's series (6th order in the
third flattening n), which is accurate to nanometres within UTM zones
-- far beyond what chip georeferencing needs.

All functions are vectorised over numpy arrays and also work on Python
scalars.
"""

from __future__ import annotations

import numpy as np

# WGS84 ellipsoid
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)
WGS84_E = np.sqrt(WGS84_E2)

UTM_K0 = 0.9996
UTM_FALSE_EASTING = 500000.0

# Third flattening and rectifying radius
_N = WGS84_F / (2.0 - WGS84_F)
_A1 = (WGS84_A / (1.0 + _N)) * (1.0 + _N ** 2 / 4.0 + _N ** 4 / 64.0)

# Karney 2011 series coefficients (forward: alpha, inverse: beta)
_ALPHA = np.array([
    _N / 2 - 2 * _N ** 2 / 3 + 5 * _N ** 3 / 16 + 41 * _N ** 4 / 180
    - 127 * _N ** 5 / 288 + 7891 * _N ** 6 / 37800,
    13 * _N ** 2 / 48 - 3 * _N ** 3 / 5 + 557 * _N ** 4 / 1440
    + 281 * _N ** 5 / 630 - 1983433 * _N ** 6 / 1935360,
    61 * _N ** 3 / 240 - 103 * _N ** 4 / 140 + 15061 * _N ** 5 / 26880
    + 167603 * _N ** 6 / 181440,
    49561 * _N ** 4 / 161280 - 179 * _N ** 5 / 168 + 6601661 * _N ** 6 / 7257600,
    34729 * _N ** 5 / 80640 - 3418889 * _N ** 6 / 1995840,
    212378941 * _N ** 6 / 319334400,
])

_BETA = np.array([
    _N / 2 - 2 * _N ** 2 / 3 + 37 * _N ** 3 / 96 - _N ** 4 / 360
    - 81 * _N ** 5 / 512 + 96199 * _N ** 6 / 604800,
    _N ** 2 / 48 + _N ** 3 / 15 - 437 * _N ** 4 / 1440 + 46 * _N ** 5 / 105
    - 1118711 * _N ** 6 / 3870720,
    17 * _N ** 3 / 480 - 37 * _N ** 4 / 840 - 209 * _N ** 5 / 4480
    + 5569 * _N ** 6 / 90720,
    4397 * _N ** 4 / 161280 - 11 * _N ** 5 / 504 - 830251 * _N ** 6 / 7257600,
    4583 * _N ** 5 / 161280 - 108847 * _N ** 6 / 3991680,
    20648693 * _N ** 6 / 638668800,
])


def utm_zone_from_lonlat(lon, lat):
    """UTM zone number (1..60) for a WGS84 lon/lat.

    Handles the standard Norway (32V) and Svalbard (31X..37X) exceptions,
    matching PROJ's +proj=utm zone selection.
    """
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    zone = (np.floor((lon + 180.0) / 6.0).astype(np.int64) % 60) + 1
    # Norway exception
    norway = (lat >= 56.0) & (lat < 64.0) & (lon >= 3.0) & (lon < 12.0)
    zone = np.where(norway, 32, zone)
    # Svalbard exceptions
    sval = (lat >= 72.0) & (lat < 84.0)
    zone = np.where(sval & (lon >= 0.0) & (lon < 9.0), 31, zone)
    zone = np.where(sval & (lon >= 9.0) & (lon < 21.0), 33, zone)
    zone = np.where(sval & (lon >= 21.0) & (lon < 33.0), 35, zone)
    zone = np.where(sval & (lon >= 33.0) & (lon < 42.0), 37, zone)
    if zone.ndim == 0:
        return int(zone)
    return zone


def zone_central_meridian_deg(zone) -> float:
    return -183.0 + 6.0 * np.asarray(zone, dtype=np.float64)


def lonlat_to_tm(lon, lat, lon0_deg, false_northing=0.0):
    """Forward transverse Mercator: WGS84 degrees -> (easting, northing) metres.

    Northing is measured from the equator (negative in the southern
    hemisphere unless a false_northing is supplied). This framework's
    tile grid keeps false_northing=0 and allows negative northings so
    tile keys stay hemisphere-agnostic (see geo/tilegrid.py).
    """
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    phi = np.radians(lat)
    lam = np.radians(lon - lon0_deg)
    # wrap to [-pi, pi]
    lam = (lam + np.pi) % (2.0 * np.pi) - np.pi

    sphi = np.sin(phi)
    # conformal latitude tangent via Karney's tau -> tau'
    e = WGS84_E
    tau = np.tan(phi)
    sigma = np.sinh(e * np.arctanh(e * sphi))
    taup = tau * np.sqrt(1.0 + sigma ** 2) - sigma * np.sqrt(1.0 + tau ** 2)

    xi_p = np.arctan2(taup, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.hypot(taup, np.cos(lam)))

    xi = xi_p.copy()
    eta = eta_p.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        xi = xi + _ALPHA[j] * np.sin(k * xi_p) * np.cosh(k * eta_p)
        eta = eta + _ALPHA[j] * np.cos(k * xi_p) * np.sinh(k * eta_p)

    easting = UTM_FALSE_EASTING + UTM_K0 * _A1 * eta
    northing = false_northing + UTM_K0 * _A1 * xi
    return easting, northing


def tm_to_lonlat(easting, northing, lon0_deg, false_northing=0.0):
    """Inverse transverse Mercator: metres -> WGS84 degrees (lon, lat)."""
    easting = np.asarray(easting, dtype=np.float64)
    northing = np.asarray(northing, dtype=np.float64)
    xi = (northing - false_northing) / (UTM_K0 * _A1)
    eta = (easting - UTM_FALSE_EASTING) / (UTM_K0 * _A1)

    xi_p = xi.copy()
    eta_p = eta.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        xi_p = xi_p - _BETA[j] * np.sin(k * xi) * np.cosh(k * eta)
        eta_p = eta_p - _BETA[j] * np.cos(k * xi) * np.sinh(k * eta)

    # tau' of the conformal latitude
    taup = np.sin(xi_p) / np.hypot(np.sinh(eta_p), np.cos(xi_p))

    # Newton-iterate tau from tau' (Karney): 3 iterations reach ~nm
    e = WGS84_E
    e2 = WGS84_E2
    tau = taup / np.sqrt(1.0 - e2)  # first guess (spherical-ish)
    for _ in range(5):
        sigma = np.sinh(e * np.arctanh(e * tau / np.sqrt(1.0 + tau ** 2)))
        f = tau * np.sqrt(1.0 + sigma ** 2) - sigma * np.sqrt(1.0 + tau ** 2) - taup
        dtau = (np.sqrt((1.0 + sigma ** 2) * (1.0 + tau ** 2)) - sigma * tau) \
            * (1.0 - e2) * np.sqrt(1.0 + tau ** 2) / (1.0 + (1.0 - e2) * tau ** 2)
        tau = tau - f / dtau

    phi = np.arctan(tau)
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    lon = np.degrees(lam) + lon0_deg
    lon = (lon + 180.0) % 360.0 - 180.0
    lat = np.degrees(phi)
    return lon, lat


def lonlat_to_utm(lon, lat, zone):
    """WGS84 -> UTM easting/northing in the given zone, equator-referenced
    northing (negative south of the equator)."""
    lon0 = zone_central_meridian_deg(zone)
    return lonlat_to_tm(lon, lat, lon0, false_northing=0.0)


def utm_to_lonlat(easting, northing, zone):
    lon0 = zone_central_meridian_deg(zone)
    return tm_to_lonlat(easting, northing, lon0, false_northing=0.0)


def boundary_samples(x0, y0, x1, y1):
    """Corner + edge-midpoint sample points of a rectangle (8 points,
    as (xs, ys) float64 arrays). The standard sampling for
    reprojecting a UTM-aligned bbox: meridian convergence bows the
    straight edges by far less than the margins callers apply."""
    xs = np.array([x0, (x0 + x1) / 2, x1, x0, x1, x0, (x0 + x1) / 2,
                   x1], np.float64)
    ys = np.array([y0, y0, y0, (y0 + y1) / 2, (y0 + y1) / 2, y1, y1,
                   y1], np.float64)
    return xs, ys


def utm_bounds_to_lonlat_bbox(bounds, zone, margin: float = 0.0):
    """Equator-referenced UTM [x0, y0, x1, y1] -> WGS84
    (w, s, e, n) bbox via 8 boundary samples, padded by ``margin``
    degrees. Shared by the STAC search bbox, the label spatial-index
    query, and zone-reprojected catalog bounds."""
    x0, y0, x1, y1 = (float(v) for v in bounds)
    xs, ys = boundary_samples(x0, y0, x1, y1)
    lon, lat = utm_to_lonlat(xs, ys, zone)
    return (float(lon.min()) - margin, float(lat.min()) - margin,
            float(lon.max()) + margin, float(lat.max()) + margin)


def utm_wkt(zone: int, north: bool = True) -> str:
    """OGC WKT1 for EPSG:326xx / 327xx, equivalent to what GDAL attaches to
    the reference's GeoTIFF chips (_descartes_img_chips.py:846-848)."""
    hemi = "N" if north else "S"
    epsg = (32600 if north else 32700) + zone
    fn = 0.0 if north else 10000000.0
    cm = zone_central_meridian_deg(zone)
    return (
        f'PROJCS["WGS 84 / UTM zone {zone}{hemi}",'
        f'GEOGCS["WGS 84",DATUM["WGS_1984",'
        f'SPHEROID["WGS 84",6378137,298.257223563,'
        f'AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
        f'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
        f'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
        f'AUTHORITY["EPSG","4326"]],'
        f'PROJECTION["Transverse_Mercator"],'
        f'PARAMETER["latitude_of_origin",0],'
        f'PARAMETER["central_meridian",{cm:g}],'
        f'PARAMETER["scale_factor",0.9996],'
        f'PARAMETER["false_easting",500000],'
        f'PARAMETER["false_northing",{fn:g}],'
        f'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
        f'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
        f'AUTHORITY["EPSG","{epsg}"]]'
    )
