"""Catalog interface, default-catalog registry and the host-side
resamplers that put a scene onto a tile's grid (a copy of the JAX
package's ``catalog/base.py``: numpy, the same arithmetic in the same
order, so resampled stacks are bitwise equal)."""

from __future__ import annotations

import datetime as _dt
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class SceneMeta:
    """Metadata for one scene of one product."""
    scene_id: str
    product: str
    date: _dt.date
    cloud_fraction: Optional[float] = None
    path: Optional[str] = None  # backend-specific locator
    extra: dict = field(default_factory=dict)

    @property
    def properties(self) -> dict:
        """DL-scene-like property access (scene.properties['date'],
        reference _descartes_img_chips.py:466)."""
        return {"date": _dt.datetime.combine(self.date, _dt.time()),
                "cloud_fraction": self.cloud_fraction, **self.extra}


class Catalog:
    """Scene source for chip creation. Implementations must be
    thread-safe for concurrent per-tile loads."""

    def products(self) -> List[str]:
        raise NotImplementedError

    def bands(self, product: str) -> List[str]:
        raise NotImplementedError

    def search(self, tile, product: str,
               start: Optional[_dt.date] = None,
               end: Optional[_dt.date] = None,
               max_cloud_fraction: Optional[float] = None
               ) -> List[SceneMeta]:
        """Scenes of ``product`` intersecting ``tile``, date-filtered
        (inclusive) and cloud-filtered (strict <, matching the
        reference's `cloud_fraction < max` query,
        _descartes_img_chips.py:610). Sorted by date ascending.

        Implementations may accept a ``processing_level`` keyword
        (e.g. "surface", the reference's surface-reflectance request at
        _descartes_img_chips.py:617-627) for remote backends that
        serve multiple processing levels; the local backends store
        scenes at a single level and ignore it."""
        raise NotImplementedError

    def load(self, scenes: Sequence[SceneMeta], tile,
             bands: Sequence[str], resampler: str = "near"
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Materialise the scene stack on the tile's padded geocontext.

        Returns (stack (S, H, W, B) source dtype, valid (S, H, W) bool)
        where H = W = tile.raster_size, resampled with ``resampler``
        (one of catalog.base.RESAMPLERS -- the full GDAL kernel set:
        near | bilinear | cubic | cubicspline | lanczos -- matching
        the reference's mosaic resampler argument,
        _descartes_img_chips.py:483, 512-513)."""
        raise NotImplementedError


_default: Optional[Catalog] = None


def set_default_catalog(catalog: Optional[Catalog]) -> None:
    global _default
    _default = catalog


def get_default_catalog() -> Catalog:
    """The process-default catalog. Resolution order: explicit
    set_default_catalog(); $DLSEG_CATALOG (path to a LocalCatalog
    root); error otherwise."""
    global _default
    if _default is not None:
        return _default
    root = os.environ.get("DLSEG_CATALOG")
    if root:
        from .local import LocalCatalog
        _default = LocalCatalog(root)
        return _default
    raise RuntimeError(
        "no catalog configured: call set_default_catalog(...) or set "
        "$DLSEG_CATALOG to a local catalog root")


RESAMPLERS = ("near", "bilinear", "cubic", "cubicspline", "lanczos")


def validate_resampler(name: str) -> None:
    """Reject unknown resampler names with one shared message (used by
    every entry point that accepts the reference's ``resampler``
    argument, _descartes_img_chips.py:483, 512-513)."""
    if name not in RESAMPLERS:
        raise ValueError(f"unknown resampler {name!r} "
                         f"(expected one of {', '.join(map(repr, RESAMPLERS))})")


def _epsg_zone(epsg: Optional[int]) -> Optional[int]:
    """UTM zone of an EPSG code (326xx north / 327xx south), else None."""
    if epsg is None:
        return None
    e = int(epsg)
    if 32601 <= e <= 32660:
        return e - 32600
    if 32701 <= e <= 32760:
        return e - 32700
    return None


def _cubic_weights(t: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Keys cubic-convolution weights (a = -0.5, GDAL's 'cubic') for
    the 4 taps at offsets -1, 0, +1, +2 around fractional position
    ``t`` in [0, 1)."""
    a = -0.5
    t2 = t * t
    t3 = t2 * t
    # |x| in (1, 2): a|x|^3 - 5a|x|^2 + 8a|x| - 4a, at x = 1+t and 2-t
    w0 = a * (t3 - 2.0 * t2 + t)                    # tap at -1 (x=1+t)
    w1 = (a + 2.0) * t3 - (a + 3.0) * t2 + 1.0      # tap at 0
    w2 = -(a + 2.0) * t3 + (2.0 * a + 3.0) * t2 - a * t  # tap at +1
    w3 = a * (t2 - t3)                              # tap at +2 (x=2-t)
    return w0, w1, w2, w3


def _bspline_weights(t: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Cubic B-spline weights (GDAL's 'cubicspline': approximating,
    non-negative, smoothing) for the 4 taps at offsets -1, 0, +1, +2
    around fractional position ``t`` in [0, 1)."""
    t2 = t * t
    t3 = t2 * t
    u = 1.0 - t
    w0 = u * u * u / 6.0                            # tap at -1 (x=1+t)
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0          # tap at 0
    w2 = (4.0 - 6.0 * u * u + 3.0 * u * u * u) / 6.0  # tap at +1
    w3 = t3 / 6.0                                   # tap at +2 (x=2-t)
    return w0, w1, w2, w3


def _lanczos_weights(t: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Lanczos a=3 windowed-sinc weights (GDAL's 'lanczos') for the 6
    taps at offsets -2..+3 around fractional position ``t`` in [0, 1),
    normalized so each axis' truncated window sums to 1 (GDAL likewise
    normalizes by the accumulated weight)."""
    ws = []
    for j in (-2, -1, 0, 1, 2, 3):
        x = t - j
        ws.append(np.sinc(x) * np.sinc(x / 3.0))
    total = sum(ws)
    return tuple(w / total for w in ws)


# tap offsets + weight function per convolution-kernel resampler;
# "near"/"bilinear" keep their dedicated paths
_KERNELS = {
    "cubic": ((-1, 0, 1, 2), _cubic_weights),
    "cubicspline": ((-1, 0, 1, 2), _bspline_weights),
    "lanczos": ((-2, -1, 0, 1, 2, 3), _lanczos_weights),
}


def equator_referenced_gt(gt: Sequence[float],
                          epsg: Optional[int]) -> Tuple[float, ...]:
    """Normalize a geotransform to the grid's internal
    equator-referenced frame: UTM-south CRSes (EPSG:327xx) carry a
    10^7 m false northing that is subtracted here, so scene rasters
    from either hemisphere convention compare directly against
    ``tile.bounds`` / ``tile.geotrans_equator``."""
    gt = tuple(float(v) for v in gt)
    if epsg is not None and 32701 <= int(epsg) <= 32760:
        return gt[:3] + (gt[3] - 10_000_000.0,) + gt[4:]
    return gt


def reproject_bounds(bounds: Sequence[float], from_zone: int,
                     to_zone: int, margin: float = 0.0) -> List[float]:
    """[x0, y0, x1, y1] (equator-referenced UTM) re-expressed in
    another zone's frame: 8 boundary samples through WGS84, min/maxed,
    padded by ``margin`` metres (the curved image of a straight UTM
    edge bows by far less than typical margins at scene scales).
    Same-zone passes through with only the margin applied."""
    x0, y0, x1, y1 = (float(v) for v in bounds)
    if from_zone == to_zone:
        return [x0 - margin, y0 - margin, x1 + margin, y1 + margin]
    from ..geo import crs as _crs
    xs, ys = _crs.boundary_samples(x0, y0, x1, y1)
    lon, lat = _crs.utm_to_lonlat(xs, ys, from_zone)
    tx, ty = _crs.lonlat_to_utm(lon, lat, to_zone)
    return [float(np.min(tx)) - margin, float(np.min(ty)) - margin,
            float(np.max(tx)) + margin, float(np.max(ty)) + margin]


def bounds_in_tile_zone(bounds: Sequence[float], epsg: Optional[int],
                        tile) -> List[float]:
    """Scene bounds re-expressed in the tile's zone for search-time
    bbox pruning (a pruning test must never falsely drop, hence the
    cross-zone margin)."""
    zone = _epsg_zone(epsg)
    if zone is None or getattr(tile, "zone", None) is None \
            or zone == tile.zone:
        return list(bounds)
    return reproject_bounds(bounds, zone, tile.zone, margin=200.0)


# extra source pixels around a tile window so interpolating
# resamplers have real neighbours at the window edge (bilinear needs
# 1, cubic/cubicspline need 2, lanczos needs 3); kernel resamplers
# derive theirs from the tap table so a wider kernel added to
# _KERNELS can never silently under-read its window
WINDOW_MARGIN = 2


def _window_margin(resampler: str) -> int:
    if resampler in _KERNELS:
        return max(abs(o) for o in _KERNELS[resampler][0])
    return WINDOW_MARGIN


def load_scene_window(reader, info, tile, band_sel: Sequence[int],
                      nodata: Optional[float], resampler: str
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One scene -> the tile's padded grid through a WINDOWED reader
    (raster/cog.py CogReader over a local file's byte ranges): only
    the source pixels the tile touches are read/decoded. Used by
    LocalCatalog's big-scene path. Cross-zone scenes
    get the tile bounds re-expressed in THEIR zone first."""
    sgt = equator_referenced_gt(info.geotransform, info.epsg)
    src_zone = _epsg_zone(info.epsg) or getattr(tile, "zone", None)
    if src_zone is not None and src_zone != tile.zone:
        tx0, ty0, tx1, ty1 = reproject_bounds(
            tile.bounds, tile.zone, src_zone, margin=50.0)
    else:
        src_zone = tile.zone
        tx0, ty0, tx1, ty1 = tile.bounds
    margin = _window_margin(resampler)
    c0 = int(np.floor((tx0 - sgt[0]) / sgt[1])) - margin
    c1 = int(np.ceil((tx1 - sgt[0]) / sgt[1])) + margin
    r0 = int(np.floor((ty1 - sgt[3]) / sgt[5])) - margin
    r1 = int(np.ceil((ty0 - sgt[3]) / sgt[5])) + margin
    win, (oy, ox) = reader.read_window(r0, c0, r1, c1)
    n = tile.raster_size
    if win.size == 0:
        return (np.zeros((n, n, len(band_sel)), win.dtype),
                np.zeros((n, n), bool))
    win_gt = (sgt[0] + ox * sgt[1], sgt[1], 0.0,
              sgt[3] + oy * sgt[5], 0.0, sgt[5])
    return resample_to_tile(
        win[:, :, list(band_sel)], win_gt, tile, nodata=nodata,
        # win_gt is already equator-referenced: the NORTH-equivalent
        # epsg carries the zone for cross-zone warping without
        # re-stripping a southern false northing
        src_epsg=32600 + src_zone, method=resampler)


def resample_to_tile(src: np.ndarray, src_gt: Sequence[float], tile,
                     nodata: Optional[float] = None,
                     src_epsg: Optional[int] = None,
                     method: str = "near"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Resample a source raster (H', W', B) with geotransform
    ``src_gt`` onto the tile's padded grid. Returns
    (out (H, W, B), valid (H, W)).

    CRS handling: pass ``src_epsg`` so (a) a southern false northing is
    normalized away and (b) a source in a DIFFERENT UTM zone is warped
    exactly — each target pixel centre maps tile-zone → WGS84 →
    source-zone (Karney series both ways, sub-mm), then samples with
    ``method``. The reference's server delivered scenes reprojected
    onto any requested geocontext (_descartes_img_chips.py:617-627);
    this is that capability client-side, so a zone-42 scene can serve
    a zone-43 tile. Same-zone inputs keep the exact separable fast
    path (bit-identical to previous behavior).

    method: "near" (nearest neighbour), "bilinear" (4-neighbour
    weighted; a target pixel is valid only when every source pixel
    with NONZERO interpolation weight is in-bounds and not nodata --
    zero-weight corners are don't-care, so a source exactly aligned
    with the tile grid keeps its full extent; still conservative vs
    GDAL's nodata-excluding weights, documented deviation), or
    "cubic" (4x4 Keys cubic convolution, a=-0.5 — GDAL's 'cubic';
    edge taps clamp, any nodata tap invalidates the pixel),
    "cubicspline" (4x4 approximating cubic B-spline — GDAL's
    'cubicspline'; same clamp/nodata rules), or "lanczos" (6x6
    Lanczos a=3 windowed sinc, per-axis weight-normalized — GDAL's
    'lanczos'; same rules). Matches the resampler values the
    reference forwarded to SceneCollection.mosaic — its docs name
    'near' and 'cubic' and defer to the DL/GDAL set for the rest
    (_descartes_img_chips.py:483, 487-488, 512-513).

    This is the local equivalent of the server-side windowing/resample
    the DL API performed for ctx-shaped mosaics."""
    validate_resampler(method)
    src_zone = _epsg_zone(src_epsg)
    cross_zone = (src_zone is not None
                  and getattr(tile, "zone", None) is not None
                  and src_zone != tile.zone)
    src_gt = equator_referenced_gt(src_gt, src_epsg)
    n = tile.raster_size
    gt = tile.geotrans_equator
    rows = np.arange(n, dtype=np.float64) + 0.5
    cols = np.arange(n, dtype=np.float64) + 0.5
    x = gt[0] + cols * gt[1]          # (W,)
    y = gt[3] + rows * gt[5]          # (H,)
    h_src, w_src = src.shape[:2]
    if cross_zone or method in _KERNELS:
        X, Y = np.meshgrid(x, y)      # (H, W) target centres
        if cross_zone:
            from ..geo import crs as _crs
            lon, lat = _crs.utm_to_lonlat(X.ravel(), Y.ravel(),
                                          tile.zone)
            xs, ys = _crs.lonlat_to_utm(lon, lat, src_zone)
            X = np.asarray(xs).reshape(n, n)
            Y = np.asarray(ys).reshape(n, n)
        return _sample_grid(src, src_gt, X, Y, nodata, method)
    if method == "bilinear":
        # fractional source pixel-CENTRE coordinates
        fx = (x - src_gt[0]) / src_gt[1] - 0.5                    # (W,)
        fy = (y - src_gt[3]) / src_gt[5] - 0.5                    # (H,)
        # valid where the target centre lies within the span of source
        # centres; corner indices clamp so the boundary case (wx or wy
        # exactly 0/1, e.g. a grid-aligned source) reads in-bounds
        # pixels and zero-weight corners never invalidate.
        in_bounds = (((fy >= 0.0) & (fy <= h_src - 1.0))[:, None]
                     & ((fx >= 0.0) & (fx <= w_src - 1.0))[None, :])
        r0 = np.clip(np.floor(fy).astype(np.int64), 0,
                     max(h_src - 2, 0))
        c0 = np.clip(np.floor(fx).astype(np.int64), 0,
                     max(w_src - 2, 0))
        wx = np.clip(fx - c0, 0.0, 1.0)[None, :, None]            # (1,W,1)
        wy = np.clip(fy - r0, 0.0, 1.0)[:, None, None]            # (H,1,1)
        r1 = np.minimum(r0 + 1, h_src - 1)
        c1 = np.minimum(c0 + 1, w_src - 1)
        q00 = src[r0[:, None], c0[None, :]].astype(np.float64)
        q01 = src[r0[:, None], c1[None, :]].astype(np.float64)
        q10 = src[r1[:, None], c0[None, :]].astype(np.float64)
        q11 = src[r1[:, None], c1[None, :]].astype(np.float64)
        res = (q00 * (1 - wx) * (1 - wy) + q01 * wx * (1 - wy)
               + q10 * (1 - wx) * wy + q11 * wx * wy)
        valid = in_bounds
        if nodata is not None:
            w00 = ((1 - wx) * (1 - wy))[:, :, 0]
            w01 = (wx * (1 - wy))[:, :, 0]
            w10 = ((1 - wx) * wy)[:, :, 0]
            w11 = (wx * wy)[:, :, 0]
            corner_nodata = (
                ((w00 > 0) & np.all(q00 == nodata, axis=-1))
                | ((w01 > 0) & np.all(q01 == nodata, axis=-1))
                | ((w10 > 0) & np.all(q10 == nodata, axis=-1))
                | ((w11 > 0) & np.all(q11 == nodata, axis=-1)))
            valid = valid & ~corner_nodata
        if np.issubdtype(src.dtype, np.integer):
            res = np.rint(res)
        out = np.where(valid[:, :, None], res, 0).astype(src.dtype)
        return out, valid
    sc = np.floor((x - src_gt[0]) / src_gt[1]).astype(np.int64)   # (W,)
    sr = np.floor((y - src_gt[3]) / src_gt[5]).astype(np.int64)   # (H,)
    in_c = (sc >= 0) & (sc < w_src)
    in_r = (sr >= 0) & (sr < h_src)
    scc = np.clip(sc, 0, w_src - 1)
    srr = np.clip(sr, 0, h_src - 1)
    out = src[srr[:, None], scc[None, :]]
    valid = in_r[:, None] & in_c[None, :]
    if nodata is not None:
        valid = valid & ~np.all(out == nodata, axis=-1)
    out = np.where(valid[:, :, None], out, 0).astype(src.dtype)
    return out, valid


def _sample_grid(src: np.ndarray, src_gt: Sequence[float],
                 X: np.ndarray, Y: np.ndarray,
                 nodata: Optional[float], method: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample ``src`` at arbitrary per-pixel target coordinates
    (X, Y) — the general path behind cross-zone warps and the cubic
    kernel. Semantics per method mirror the separable fast paths in
    resample_to_tile (same validity rules), they just accept full
    (H, W) coordinate grids."""
    h_src, w_src = src.shape[:2]
    if method == "near":
        sc = np.floor((X - src_gt[0]) / src_gt[1]).astype(np.int64)
        sr = np.floor((Y - src_gt[3]) / src_gt[5]).astype(np.int64)
        valid = (sc >= 0) & (sc < w_src) & (sr >= 0) & (sr < h_src)
        out = src[np.clip(sr, 0, h_src - 1), np.clip(sc, 0, w_src - 1)]
        if nodata is not None:
            valid = valid & ~np.all(out == nodata, axis=-1)
        out = np.where(valid[:, :, None], out, 0).astype(src.dtype)
        return out, valid

    fx = (X - src_gt[0]) / src_gt[1] - 0.5    # fractional CENTRE coords
    fy = (Y - src_gt[3]) / src_gt[5] - 0.5
    in_bounds = ((fy >= 0.0) & (fy <= h_src - 1.0)
                 & (fx >= 0.0) & (fx <= w_src - 1.0))

    if method == "bilinear":
        r0 = np.clip(np.floor(fy).astype(np.int64), 0, max(h_src - 2, 0))
        c0 = np.clip(np.floor(fx).astype(np.int64), 0, max(w_src - 2, 0))
        wx = np.clip(fx - c0, 0.0, 1.0)[:, :, None]
        wy = np.clip(fy - r0, 0.0, 1.0)[:, :, None]
        r1 = np.minimum(r0 + 1, h_src - 1)
        c1 = np.minimum(c0 + 1, w_src - 1)
        q00 = src[r0, c0].astype(np.float64)
        q01 = src[r0, c1].astype(np.float64)
        q10 = src[r1, c0].astype(np.float64)
        q11 = src[r1, c1].astype(np.float64)
        res = (q00 * (1 - wx) * (1 - wy) + q01 * wx * (1 - wy)
               + q10 * (1 - wx) * wy + q11 * wx * wy)
        valid = in_bounds
        if nodata is not None:
            w00 = ((1 - wx) * (1 - wy))[:, :, 0]
            w01 = (wx * (1 - wy))[:, :, 0]
            w10 = ((1 - wx) * wy)[:, :, 0]
            w11 = (wx * wy)[:, :, 0]
            corner_nodata = (
                ((w00 > 0) & np.all(q00 == nodata, axis=-1))
                | ((w01 > 0) & np.all(q01 == nodata, axis=-1))
                | ((w10 > 0) & np.all(q10 == nodata, axis=-1))
                | ((w11 > 0) & np.all(q11 == nodata, axis=-1)))
            valid = valid & ~corner_nodata
        if np.issubdtype(src.dtype, np.integer):
            res = np.rint(res)
        out = np.where(valid[:, :, None], res, 0).astype(src.dtype)
        return out, valid

    # convolution kernels (cubic / cubicspline / lanczos): separable
    # taps around (r0, c0); edge taps clamp
    offsets, weight_fn = _KERNELS[method]
    r0 = np.floor(fy).astype(np.int64)
    c0 = np.floor(fx).astype(np.int64)
    ty = np.clip(fy - r0, 0.0, 1.0)
    tx = np.clip(fx - c0, 0.0, 1.0)
    wys = weight_fn(ty)
    wxs = weight_fn(tx)
    res = np.zeros(X.shape + (src.shape[2],), np.float64)
    tap_nodata = np.zeros(X.shape, bool)
    for j, wy in zip(offsets, wys):
        rj = np.clip(r0 + j, 0, h_src - 1)
        for i, wx in zip(offsets, wxs):
            ci = np.clip(c0 + i, 0, w_src - 1)
            q = src[rj, ci]
            res += (wy * wx)[:, :, None] * q.astype(np.float64)
            if nodata is not None:
                tap_nodata |= np.all(q == nodata, axis=-1)
    valid = in_bounds & ~tap_nodata
    if np.issubdtype(src.dtype, np.integer):
        finfo = np.iinfo(src.dtype)
        res = np.clip(np.rint(res), finfo.min, finfo.max)
    out = np.where(valid[:, :, None], res, 0).astype(src.dtype)
    return out, valid
