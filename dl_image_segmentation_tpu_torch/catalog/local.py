"""LocalCatalog: GeoTIFF scenes behind a JSON manifest, on local disk
or under a gs://, s3:// or http(s):// prefix.

A copy of the JAX package's ``catalog/local.py``. All IO of a remote
root rides the storage layer, so a bucket of COG scenes is a catalog:
big remote scenes are read by byte range, never downloaded whole.

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
(raster/cog.py over ``os.pread``, or ``storage.read_range`` for a
remote root: only the internal tiles a chip touches are decoded); smaller scenes are decoded whole into an LRU that
serves many tiles. The export's gather threads call ``load``
concurrently: the LRU and the reader cache share one lock, and windowed
reads are positionless.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import storage
from ..raster.geotiff import read_geotiff
from .base import (Catalog, SceneMeta, bounds_in_tile_zone,
                   equator_referenced_gt, load_scene_window,
                   validate_resampler, resample_to_tile)

__all__ = ["LocalCatalog"]

def _write_bytes(path: str, data: bytes) -> None:
    """Atomic write: one object creation on a remote root; locally a
    tmp file named per process and thread, then a rename."""
    if storage.is_remote(path):
        storage.write_bytes(path, data)
        return
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
        self.root = root
        self._index = json.loads(storage.read_bytes(
            storage.join(root, "index.json")).decode("utf-8"))
        self._lock = threading.Lock()
        self._cache: Dict[str, object] = {}
        self._cache_order: List[str] = []
        self._bands: Dict[str, object] = {}  # SAFE band files
        self._band_order: List[str] = []
        self._band_locks: Dict[str, threading.Lock] = {}
        self._cache_max = cache_scenes
        self._bounds_cache: Dict[str, list] = {}
        self._size_cache: Dict[str, int] = {}
        self._window_bytes = window_bytes
        self._readers: Dict[str, tuple] = {}  # path -> (reader, info)

    # -- write-side helper for building catalogs ------------------------
    @classmethod
    def create(cls, root: str) -> "LocalCatalog":
        storage.makedirs(storage.join(root, "scenes"), exist_ok=True)
        idx = storage.join(root, "index.json")
        if not storage.exists(idx):
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
        write_geotiff(storage.join(self.root, rel), array,
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
        _write_bytes(storage.join(self.root, "index.json"),
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
        for f in storage.glob(storage.join(folder, "*.tif")):
            g = read_geotiff(f)
            if g.info.geotransform is None or g.info.epsg is None:
                continue
            sid = (f"{product.replace(':', '_')}-"
                   f"{os.path.splitext(storage.basename(f))[0]}")
            self.add_scene(product, bands, sid, date, g.array,
                           g.info.geotransform, g.info.epsg,
                           cloud_fraction=cloud_fraction,
                           nodata=g.info.nodata, save_index=False)
            n += 1
        if n:
            self._save_index()
        return n

    # canonical Sentinel-2 band order (the L1C/L2A granule set; B8A
    # sits between B08 and B09 per ESA's band numbering)
    _S2_BAND_ORDER = ("B01", "B02", "B03", "B04", "B05", "B06", "B07",
                      "B08", "B8A", "B09", "B10", "B11", "B12")

    def ingest_safe(self, safe_dir: str,
                    product: str = "sentinel-2:L1C",
                    cloud_fraction: Optional[float] = None) -> int:
        """Walk a Sentinel-2 ``.SAFE`` directory (the ESA distribution
        convention: ``GRANULE/<id>/IMG_DATA/*_Bxx.jp2``, local or under a
        gs://, s3:// or http(s):// prefix) and register each granule as
        one scene with per-band JP2 assets. Bounds and EPSG come from a
        header-only sniff of the finest band (GeoJP2 or GMLJP2); mixed
        10/20/60 m bands need no resample here because load() warps each
        band file onto the tile grid on its own. Returns the granules
        registered."""
        import re as _re

        from ..raster.jp2 import sniff_jp2_info

        gran_root = storage.join(safe_dir, "GRANULE")
        try:
            granules = storage.listdir(gran_root)
        except (FileNotFoundError, NotADirectoryError, OSError):
            raise FileNotFoundError(
                f"{safe_dir!r} has no GRANULE/ directory -- not a "
                ".SAFE product tree")
        n = 0
        for gran in granules:
            img_dir = storage.join(gran_root, gran, "IMG_DATA")
            try:
                files = storage.listdir(img_dir)
            except (FileNotFoundError, NotADirectoryError, OSError):
                continue
            band_paths: Dict[str, str] = {}
            date = None
            for fn in files:
                m = _re.search(r"_(B(?:\d\d|8A))\.jp2$", fn)
                if not m:
                    continue  # TCI previews, QI masks, metadata
                band_paths[m.group(1)] = storage.join(img_dir, fn)
                if date is None:
                    dm = _re.search(r"(\d{8})T\d{6}", fn)
                    if dm:
                        date = _dt.datetime.strptime(
                            dm.group(1), "%Y%m%d").date()
            if not band_paths:
                continue
            if date is None:
                dm = _re.search(r"(\d{8})T\d{6}",
                                storage.basename(safe_dir.rstrip("/")))
                date = (_dt.datetime.strptime(dm.group(1), "%Y%m%d")
                        .date() if dm else _dt.date(1970, 1, 1))
            bands = [b for b in self._S2_BAND_ORDER if b in band_paths]
            # bounds from the finest-resolution band present
            ref = band_paths[bands[min(range(len(bands)), key=lambda i:
                             0 if bands[i] in ("B02", "B03", "B04",
                                               "B08") else 1)]]
            info = sniff_jp2_info(storage.read_bytes(ref))
            if info.geotransform is None or info.epsg is None:
                raise ValueError(
                    f"SAFE band {ref!r} carries no GeoJP2/GMLJP2 "
                    "georeferencing")
            gt = equator_referenced_gt(info.geotransform, info.epsg)
            bounds = [gt[0], gt[3] + info.height * gt[5],
                      gt[0] + info.width * gt[1], gt[3]]
            prods = self._index.setdefault("products", {})
            p = prods.setdefault(product,
                                 {"bands": bands, "scenes": []})
            missing = [b for b in bands if b not in p["bands"]]
            if missing:
                raise ValueError(
                    f"granule {gran!r} carries bands {missing} not in "
                    f"product {product!r}'s band list {p['bands']}")
            entry = {"id": gran, "date": date.isoformat(),
                     "band_paths": band_paths, "bounds": bounds,
                     "epsg": int(info.epsg)}
            if cloud_fraction is not None:
                entry["cloud_fraction"] = cloud_fraction
            p["scenes"].append(entry)
            n += 1
        if n:
            self._save_index()
        return n

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
        self._prefetch_bands(scenes, bands)
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
        info = decode_geotiff_info(storage.read_bytes(
            storage.join(self.root, rel_path)))
        gt = equator_referenced_gt(info.geotransform, info.epsg)
        b = ([gt[0], gt[3] + info.height * gt[5],
              gt[0] + info.width * gt[1], gt[3]], info.epsg)
        with self._lock:
            self._bounds_cache[rel_path] = b
        return b

    def _scene_size(self, rel_path: str) -> int:
        # memoized: scenes are immutable, and on a remote root an
        # uncached stat would cost one HTTP round trip per (tile, scene)
        # across a whole export
        with self._lock:
            hit = self._size_cache.get(rel_path)
        if hit is not None:
            return hit
        full = storage.join(self.root, rel_path)
        try:
            size = storage.size(full)
        except OSError:
            size = 0
        with self._lock:
            self._size_cache[rel_path] = size
        return size

    def _window_reader(self, rel_path: str):
        """(CogReader over byte ranges, RasterInfo) for a big scene,
        cached per path (the reader holds the parsed header; windowed
        reads are stateless, so one reader serves concurrent tiles).
        Local files use pread; remote scenes use ranged GETs."""
        with self._lock:
            hit = self._readers.get(rel_path)
        if hit is not None:
            return hit
        from ..raster.cog import CogReader
        full = storage.join(self.root, rel_path)
        f = None
        if storage.is_remote(full):
            def fetch(start, length, _p=full):
                return storage.read_range(_p, start, start + length - 1)
        else:
            f = open(full, "rb")

            def fetch(start, length, _f=f):
                # pread: positionless, safe under concurrent tile loads
                return os.pread(_f.fileno(), length, start)

        reader = CogReader(fetch)
        pair = (reader, reader.info)
        with self._lock:
            if rel_path in self._readers:  # another thread won the race
                if f is not None:
                    f.close()
            else:
                self._readers[rel_path] = pair
            return self._readers[rel_path]

    def _prefetch_bands(self, scenes: Sequence[SceneMeta],
                        bands: Sequence[str]) -> None:
        """Decode the band files of ``scenes`` that are not in the band
        LRU on a thread each (up to the host's cores; the JPEG 2000
        decoder releases the GIL), so that a tile of 13-band SAFE scenes
        waits for the slowest file, not for the sum of them."""
        paths = [m.extra["band_paths"][b] for m in scenes
                 if m.extra.get("band_paths") for b in bands
                 if b in m.extra["band_paths"]]
        with self._lock:
            missing = list(dict.fromkeys(p for p in paths
                                         if p not in self._bands))
        if len(missing) < 2:
            return
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(len(missing),
                                    os.cpu_count() or 1)) as ex:
            for f in [ex.submit(self._load_band_raster, p)
                      for p in missing]:
                f.result()

    def _load_band_raster(self, path: str):
        """One SAFE band file through the band LRU. ``path`` is stored
        as written by ingest_safe -- a full path or URL, independent of
        the catalog root. Any raster the port decodes may be a band
        file: JPEG 2000 (the .SAFE band files), GeoTIFF, NetCDF, VRT,
        GeoPackage, NITF, ... The bytes are decoded bare, as the JAX
        package decodes them, so an ENVI header or a VRT with
        relativeToVRT sources fails here; HDF5 / NetCDF-4 band files
        decode with the port's own reader.

        The LRU holds ``cache_scenes`` scenes' worth of band files (13
        each), where the JAX package puts them in its scene LRU of
        ``cache_scenes`` entries: a 13-band granule there evicts its own
        bands, and every tile decodes each band file again. A file being
        decoded is decoded once: the export's other gather threads wait
        for it."""
        with self._lock:
            g = self._bands.get(path)
            if g is not None:
                return g
            busy = self._band_locks.setdefault(path, threading.Lock())
        with busy:
            with self._lock:
                g = self._bands.get(path)
            if g is not None:
                return g
            from ..raster.image import decode_image_bytes
            g = decode_image_bytes(storage.read_bytes(path))
            with self._lock:
                self._bands[path] = g
                self._band_order.append(path)
                if len(self._band_order) > (self._cache_max
                                            * len(self._S2_BAND_ORDER)):
                    self._bands.pop(self._band_order.pop(0), None)
        return g

    # -- scene cache ------------------------------------------------------
    def _load_scene(self, rel_path: str):
        with self._lock:
            if rel_path in self._cache:
                return self._cache[rel_path]
        g = read_geotiff(storage.join(self.root, rel_path))
        with self._lock:
            if rel_path not in self._cache:
                self._cache[rel_path] = g
                self._cache_order.append(rel_path)
                if len(self._cache_order) > self._cache_max:
                    old = self._cache_order.pop(0)
                    self._cache.pop(old, None)
        return g
