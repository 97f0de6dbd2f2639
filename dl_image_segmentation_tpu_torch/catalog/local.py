"""LocalCatalog: GeoTIFF scenes on local disk behind a JSON manifest.

A copy of the JAX package's ``catalog/local.py`` for local roots (that
package reaches its files through a storage layer that also serves
gs:// and s3:// prefixes; object storage is ROADMAP queue 1 item 3 here,
and a remote root raises).

Layout:
    root/
      index.json
      scenes/<files>.tif

index.json schema:
    {"products": {
        "<product_id>": {
          "bands": ["red", "green", "blue", ...],
          "scenes": [
            {"id": "...", "date": "2020-01-05",
             "cloud_fraction": 0.12,          # optional
             "path": "scenes/a.tif",          # relative to root
             "nodata": 0                      # optional
            }, ...]
        }}}

Scene rasters carry their own geotransform + EPSG (our GeoTIFF tags).
Scenes in a DIFFERENT UTM zone than the tile are warped exactly onto
the tile grid at load time (per-pixel tile-zone -> WGS84 -> scene-zone
lookup inside resample_to_tile), so a zone-42 scene can serve a
zone-43 tile -- the client-side equivalent of the reference server's
any-geocontext reprojection (_descartes_img_chips.py:617-627).

Scene files of at least ``window_bytes`` are read windowed
(raster/cog.py over ``os.pread``: only the internal tiles a chip
touches are decoded); smaller scenes are decoded whole into an LRU that
serves many tiles. The export's gather threads call ``load``
concurrently: the LRU and the reader cache share one lock, and windowed
reads are positionless.
"""

from __future__ import annotations

import datetime as _dt
import glob
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..raster.geotiff import read_geotiff
from .base import (Catalog, SceneMeta, bounds_in_tile_zone,
                   equator_referenced_gt, load_scene_window,
                   validate_resampler, resample_to_tile)

__all__ = ["LocalCatalog"]

_REMOTE = ("gs://", "s3://", "http://", "https://")
REMOTE_NOT_PORTED = ("remote catalog roots are not ported yet: ROADMAP "
                     "queue 1 item 3 (storage schemes and remote "
                     "catalogs); use a local root")
SAFE_NOT_PORTED = ("Sentinel-2 .SAFE ingestion needs the JP2 decoder, "
                   "which is not ported yet: ROADMAP queue 1 item 6")


def _check_local_root(root: str) -> str:
    if str(root).startswith(_REMOTE):
        raise NotImplementedError(f"{root}: {REMOTE_NOT_PORTED}")
    return root


def _write_bytes(path: str, data: bytes) -> None:
    """tmp + rename, as the JAX package's storage layer writes locally."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class LocalCatalog(Catalog):
    def __init__(self, root: str, cache_scenes: int = 16,
                 window_bytes: int = 32 << 20):
        """window_bytes: scene files at least this large are read
        WINDOWED (raster/cog.py over pread ranges -- only the internal
        TIFF tiles a chip touches are decoded) instead of
        whole-decoded into the LRU; an export over 10,000² scenes stays
        memory-bounded. Smaller scenes keep the whole-decode LRU (one
        decode serves many tiles)."""
        self.root = _check_local_root(root)
        with open(os.path.join(root, "index.json"), "rb") as f:
            self._index = json.loads(f.read().decode("utf-8"))
        self._lock = threading.Lock()
        self._cache: Dict[str, object] = {}
        self._cache_order: List[str] = []
        self._cache_max = cache_scenes
        self._bounds_cache: Dict[str, list] = {}
        self._size_cache: Dict[str, int] = {}
        self._window_bytes = window_bytes
        self._readers: Dict[str, tuple] = {}  # path -> (reader, info)

    # -- write-side helper for building catalogs ------------------------
    @classmethod
    def create(cls, root: str) -> "LocalCatalog":
        _check_local_root(root)
        os.makedirs(os.path.join(root, "scenes"), exist_ok=True)
        idx = os.path.join(root, "index.json")
        if not os.path.exists(idx):
            _write_bytes(idx, json.dumps({"products": {}}).encode())
        return cls(root)

    def add_scene(self, product: str, bands: Sequence[str],
                  scene_id: str, date: _dt.date, array: np.ndarray,
                  geotransform, epsg: int,
                  cloud_fraction: Optional[float] = None,
                  nodata: Optional[float] = None,
                  save_index: bool = True) -> None:
        from ..raster.geotiff import write_geotiff
        rel = f"scenes/{scene_id}.tif"
        write_geotiff(os.path.join(self.root, rel), array,
                      geotransform=tuple(geotransform), epsg=epsg,
                      nodata=nodata)
        prods = self._index.setdefault("products", {})
        p = prods.setdefault(product, {"bands": list(bands), "scenes": []})
        # index bounds are stored equator-referenced (southern scenes'
        # false northing removed) so search compares them directly
        # against tile.bounds
        gt = equator_referenced_gt(geotransform, epsg)
        h, w = array.shape[:2]
        bounds = [gt[0], gt[3] + h * gt[5], gt[0] + w * gt[1], gt[3]]
        entry = {"id": scene_id, "date": date.isoformat(), "path": rel,
                 "bounds": bounds, "epsg": int(epsg)}
        if cloud_fraction is not None:
            entry["cloud_fraction"] = cloud_fraction
        if nodata is not None:
            entry["nodata"] = nodata
        p["scenes"].append(entry)
        if save_index:
            self._save_index()

    def _save_index(self) -> None:
        _write_bytes(os.path.join(self.root, "index.json"),
                     json.dumps(self._index).encode("utf-8"))

    def ingest_chips(self, product: str, bands: Sequence[str],
                     folder: str, date: _dt.date,
                     cloud_fraction: Optional[float] = None) -> int:
        """Register every GeoTIFF chip in a folder as scenes of a
        product -- e.g. feed ``predict`` output back in as model input
        for multi-product stacking (the reference's
        prior-model-outputs use case, _descartes_img_chips.py:493-497).
        Returns the number of scenes added."""
        n = 0
        # the index is written ONCE at the end: per-scene dumps would
        # re-serialize the whole (growing) index N times -- O(N^2) over
        # a large predict-output folder
        for f in sorted(glob.glob(os.path.join(_check_local_root(folder),
                                               "*.tif"))):
            g = read_geotiff(f)
            if g.info.geotransform is None or g.info.epsg is None:
                continue
            sid = (f"{product.replace(':', '_')}-"
                   f"{os.path.splitext(os.path.basename(f))[0]}")
            self.add_scene(product, bands, sid, date, g.array,
                           g.info.geotransform, g.info.epsg,
                           cloud_fraction=cloud_fraction,
                           nodata=g.info.nodata, save_index=False)
            n += 1
        if n:
            self._save_index()
        return n

    def ingest_safe(self, safe_dir: str,
                    product: str = "sentinel-2:L1C",
                    cloud_fraction: Optional[float] = None) -> int:
        """Sentinel-2 ``.SAFE`` trees hold JP2 band files: not ported
        (see SAFE_NOT_PORTED)."""
        raise NotImplementedError(SAFE_NOT_PORTED)

    # -- Catalog interface ----------------------------------------------
    def products(self) -> List[str]:
        return list(self._index.get("products", {}))

    def bands(self, product: str) -> List[str]:
        return list(self._index["products"][product]["bands"])

    def search(self, tile, product: str,
               start: Optional[_dt.date] = None,
               end: Optional[_dt.date] = None,
               max_cloud_fraction: Optional[float] = None
               ) -> List[SceneMeta]:
        prod = self._index.get("products", {}).get(product)
        if prod is None:
            return []
        tx0, ty0, tx1, ty1 = tile.bounds
        out = []
        for s in prod["scenes"]:
            date = _dt.date.fromisoformat(s["date"])
            if start is not None and date < start:
                continue
            if end is not None and date > end:
                continue
            cf = s.get("cloud_fraction")
            if max_cloud_fraction is not None and cf is not None \
                    and not (cf < max_cloud_fraction):
                continue
            # intersect scene bounds with the tile: indexed bounds when
            # recorded (cheap), else one header-only read (no pixel
            # decode, and never through the scene LRU). Cross-zone
            # scenes' bounds are re-expressed in the tile's zone first.
            b = s.get("bounds")
            epsg = s.get("epsg")
            if b is None:
                b, epsg = self._scene_bounds(s["path"])
            b = bounds_in_tile_zone(b, epsg, tile)
            if b[2] < tx0 or b[0] > tx1 or b[3] < ty0 or b[1] > ty1:
                continue
            extra = {"nodata": s.get("nodata")}
            if "band_paths" in s:  # SAFE-style per-band assets
                extra["band_paths"] = s["band_paths"]
            out.append(SceneMeta(s["id"], product, date, cf,
                                 s.get("path"), extra=extra))
        out.sort(key=lambda m: m.date)
        return out

    def load(self, scenes: Sequence[SceneMeta], tile,
             bands: Sequence[str], resampler: str = "near"
             ) -> Tuple[np.ndarray, np.ndarray]:
        validate_resampler(resampler)  # even when scenes is empty
        stacks = []
        valids = []
        for m in scenes:
            bp = m.extra.get("band_paths")
            if bp:
                # SAFE-style scene: one file per band, each warped
                # onto the tile grid independently (so 10/20/60 m
                # bands mix freely); valid where EVERY band has data
                outs, vals = [], []
                for b in bands:
                    rel = bp.get(b)
                    if rel is None:
                        raise KeyError(
                            f"scene {m.scene_id!r} has no band {b!r} "
                            f"(has {sorted(bp)})")
                    g = self._load_band_raster(rel)
                    o, v = resample_to_tile(
                        g.array, g.info.geotransform, tile,
                        nodata=(m.extra.get("nodata")
                                if m.extra.get("nodata") is not None
                                else g.info.nodata),
                        src_epsg=g.info.epsg, method=resampler)
                    outs.append(o[:, :, 0])
                    vals.append(v)
                stacks.append(np.stack(outs, axis=-1))
                valids.append(np.logical_and.reduce(vals))
                continue
            # band indices resolved PER SCENE: a mixed-product scene
            # list must not inherit the first product's band order
            # (SyntheticCatalog.load resolves per scene too)
            band_names = self.bands(m.product)
            sel = [band_names.index(b) for b in bands]
            nodata = m.extra.get("nodata")
            big = self._scene_size(m.path) >= self._window_bytes
            if big:
                reader, info = self._window_reader(m.path)
                if nodata is None:
                    nodata = info.nodata
                out, valid = load_scene_window(reader, info, tile, sel,
                                               nodata, resampler)
                stacks.append(out)
                valids.append(valid)
                continue
            g = self._load_scene(m.path)
            arr = g.array[:, :, sel]
            if nodata is None:
                nodata = g.info.nodata
            out, valid = resample_to_tile(arr, g.info.geotransform, tile,
                                          nodata=nodata,
                                          src_epsg=g.info.epsg,
                                          method=resampler)
            stacks.append(out)
            valids.append(valid)
        if not stacks:
            n = tile.raster_size
            return (np.zeros((0, n, n, len(bands)), np.float32),
                    np.zeros((0, n, n), bool))
        return np.stack(stacks), np.stack(valids)

    def _scene_bounds(self, rel_path: str):
        """(equator-referenced [x0, y0, x1, y1] in the SCENE's zone,
        epsg) from the GeoTIFF header only (tags, no pixel decode);
        memoized per path."""
        with self._lock:
            cached = self._bounds_cache.get(rel_path)
        if cached is not None:
            return cached
        from ..raster.geotiff import decode_geotiff_info
        with open(os.path.join(self.root, rel_path), "rb") as f:
            info = decode_geotiff_info(f.read())
        gt = equator_referenced_gt(info.geotransform, info.epsg)
        b = ([gt[0], gt[3] + info.height * gt[5],
              gt[0] + info.width * gt[1], gt[3]], info.epsg)
        with self._lock:
            self._bounds_cache[rel_path] = b
        return b

    def _scene_size(self, rel_path: str) -> int:
        # memoized: scenes are immutable, and a stat per (tile, scene)
        # adds up across a whole export
        with self._lock:
            hit = self._size_cache.get(rel_path)
        if hit is not None:
            return hit
        try:
            size = os.path.getsize(os.path.join(self.root, rel_path))
        except OSError:
            size = 0
        with self._lock:
            self._size_cache[rel_path] = size
        return size

    def _window_reader(self, rel_path: str):
        """(CogReader over pread ranges, RasterInfo) for a big scene,
        cached per path (the reader holds the parsed header; windowed
        reads are stateless, so one reader serves concurrent tiles)."""
        with self._lock:
            hit = self._readers.get(rel_path)
        if hit is not None:
            return hit
        from ..raster.cog import CogReader
        f = open(os.path.join(self.root, rel_path), "rb")

        def fetch(start, length, _f=f):
            # pread: positionless, safe under concurrent tile loads
            return os.pread(_f.fileno(), length, start)

        reader = CogReader(fetch)
        pair = (reader, reader.info)
        with self._lock:
            if rel_path in self._readers:  # another thread won the race
                f.close()
            else:
                self._readers[rel_path] = pair
            return self._readers[rel_path]

    def _load_band_raster(self, path: str):
        """One SAFE band file through the scene LRU. ``path`` is stored
        as written by ingest_safe -- a full path, independent of the
        catalog root. GeoTIFF band files decode; other containers raise
        UnsupportedFormatError naming the ROADMAP item of their
        decoder."""
        with self._lock:
            if path in self._cache:
                return self._cache[path]
        from ..raster.image import decode_image_bytes
        with open(_check_local_root(path), "rb") as f:
            g = decode_image_bytes(f.read())
        with self._lock:
            if path not in self._cache:
                self._cache[path] = g
                self._cache_order.append(path)
                if len(self._cache_order) > self._cache_max:
                    old = self._cache_order.pop(0)
                    self._cache.pop(old, None)
        return g

    # -- scene cache ------------------------------------------------------
    def _load_scene(self, rel_path: str):
        with self._lock:
            if rel_path in self._cache:
                return self._cache[rel_path]
        g = read_geotiff(os.path.join(self.root, rel_path))
        with self._lock:
            if rel_path not in self._cache:
                self._cache[rel_path] = g
                self._cache_order.append(rel_path)
                if len(self._cache_order) > self._cache_max:
                    old = self._cache_order.pop(0)
                    self._cache.pop(old, None)
        return g
