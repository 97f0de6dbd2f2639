"""HTTPCatalog: remote scene catalog over HTTP with windowed reads.

A copy of the JAX package's ``catalog/http.py``. The reference's
chip-acquisition engine is a CLIENT of a remote scene service:
``dl.scenes.search(...)`` and ``SceneCollection.mosaic(...)`` over
HTTPS (``_descartes_img_chips.py:512-513, 552-561, 612, 626``), requesting
``processing_level="surface"`` (its :617-627). This backend restores
that defining capability without the proprietary service: a plain
HTTP server (object store, CDN, nginx — anything speaking Range
requests) publishes

    {base_url}/index.json       — the LocalCatalog index schema, plus
                                  optional per-scene ``"assets"``:
                                  {"surface": path, "toa": path, ...}
    {base_url}/scenes/*.tif     — COG-style GeoTIFF scenes

and the catalog serves tiles by fetching ONLY the byte ranges of the
internal TIFF tiles a chip window touches (raster/cog.py), coalescing
nearby ranges. An export against 10,000² scenes therefore moves KB
per tile, not the scene.

``processing_level`` is REAL here (the reference asked its server for
surface reflectance): scenes publishing an ``assets`` map resolve the
requested level to a different file; single-path scenes serve every
level (a single-level catalog). Unknown levels are skipped loudly at
search time so the job's fetch-None/retry protocol sees a consistent
world.

Transient failures (429/5xx, connection resets) retry with bounded
exponential backoff inside every request (storage.gcs.http_request);
persistent failure raises, which the chip layer converts to its
(job, None, None) retry protocol (reference :589-593, 718-722).
"""

from __future__ import annotations

import datetime as _dt
import json
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..raster.cog import CogReader
from ..storage.gcs import http_request
from .base import (Catalog, SceneMeta, bounds_in_tile_zone,
                   equator_referenced_gt, load_scene_window,
                   validate_resampler)

__all__ = ["HTTPCatalog"]


class HTTPCatalog(Catalog):
    """See module docstring. Thread-safe: one CogReader per scene
    asset, created once (header fetch) and shared; windowed reads are
    stateless."""

    def __init__(self, base_url: str,
                 processing_level: Optional[str] = "surface",
                 max_attempts: int = 5, cache_readers: int = 32,
                 timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.processing_level = processing_level
        self.max_attempts = max_attempts
        self.timeout = timeout
        self._lock = threading.Lock()
        self._readers: Dict[str, CogReader] = {}
        self._reader_order: List[str] = []
        self._cache_max = cache_readers
        self.skipped_levels = 0  # scenes without the requested asset
        status, body, _ = self._get(f"{self.base_url}/index.json")
        if status == 404:
            raise FileNotFoundError(f"{self.base_url}/index.json")
        self._index = json.loads(body)

    # -- transport ------------------------------------------------------
    def _get(self, url: str, headers: Optional[dict] = None
             ) -> Tuple[int, bytes, dict]:
        return http_request("GET", url, headers=headers,
                            ok_statuses=(200, 206),
                            max_attempts=self.max_attempts,
                            timeout=self.timeout)

    def _fetch_range(self, rel_path: str, start: int, length: int
                     ) -> bytes:
        url = f"{self.base_url}/{rel_path}"
        status, body, _ = self._get(
            url, headers={"Range": f"bytes={start}-{start + length - 1}"})
        if status == 404:
            raise FileNotFoundError(url)
        if status == 416:
            return b""
        if status == 200 and start:
            # server ignored Range (no COG windowing for us) -- slice
            # the full body so correctness survives dumb servers
            return body[start:start + length]
        return body

    # -- Catalog interface ----------------------------------------------
    def products(self) -> List[str]:
        return list(self._index.get("products", {}))

    def bands(self, product: str) -> List[str]:
        return list(self._index["products"][product]["bands"])

    def search(self, tile, product: str,
               start: Optional[_dt.date] = None,
               end: Optional[_dt.date] = None,
               max_cloud_fraction: Optional[float] = None,
               processing_level: Optional[str] = None
               ) -> List[SceneMeta]:
        """Date/cloud/bbox-filtered scenes, ascending by date (the
        reference's search semantics, _descartes_img_chips.py:599-611).
        ``processing_level`` overrides the catalog default; it resolves
        each scene's asset path (see module docstring)."""
        prod = self._index.get("products", {}).get(product)
        if prod is None:
            return []
        level = processing_level if processing_level is not None \
            else self.processing_level
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
            path = self._resolve_asset(s, level)
            if path is None:
                with self._lock:
                    self.skipped_levels += 1
                print(f"WARNING: scene {s.get('id')} has no "
                      f"{level!r} asset; skipped", file=sys.stderr)
                continue
            b = s.get("bounds")
            epsg = s.get("epsg")
            if b is None:
                b, epsg = self._scene_bounds(path)
            b = bounds_in_tile_zone(b, epsg, tile)
            if b[2] < tx0 or b[0] > tx1 or b[3] < ty0 or b[1] > ty1:
                continue
            out.append(SceneMeta(s["id"], product, date, cf, path,
                                 extra={"nodata": s.get("nodata")}))
        out.sort(key=lambda m: m.date)
        return out

    @staticmethod
    def _resolve_asset(scene: dict, level: Optional[str]
                       ) -> Optional[str]:
        assets = scene.get("assets")
        if assets:
            if level is None:
                # no preference: the plain path, else any single asset
                return scene.get("path") or next(iter(assets.values()))
            return assets.get(level)
        return scene.get("path")

    def load(self, scenes: Sequence[SceneMeta], tile,
             bands: Sequence[str], resampler: str = "near"
             ) -> Tuple[np.ndarray, np.ndarray]:
        validate_resampler(resampler)
        stacks, valids = [], []
        for m in scenes:
            reader = self._reader(m.path)
            info = reader.info
            band_names = self.bands(m.product)
            sel = [band_names.index(b) for b in bands]
            nodata = m.extra.get("nodata")
            if nodata is None:
                nodata = info.nodata
            out, valid = load_scene_window(reader, info, tile, sel,
                                           nodata, resampler)
            stacks.append(out)
            valids.append(valid)
        if not stacks:
            n = tile.raster_size
            return (np.zeros((0, n, n, len(bands)), np.float32),
                    np.zeros((0, n, n), bool))
        return np.stack(stacks), np.stack(valids)

    # -- readers ----------------------------------------------------------
    def _reader(self, rel_path: str) -> CogReader:
        with self._lock:
            r = self._readers.get(rel_path)
            if r is not None:
                return r
        r = CogReader(lambda s, ln, p=rel_path: self._fetch_range(p, s,
                                                                  ln))
        with self._lock:
            if rel_path not in self._readers:
                self._readers[rel_path] = r
                self._reader_order.append(rel_path)
                if len(self._reader_order) > self._cache_max:
                    self._readers.pop(self._reader_order.pop(0), None)
            return self._readers[rel_path]

    def _scene_bounds(self, rel_path: str) -> tuple:
        """(equator-referenced bounds in the scene's zone, epsg)."""
        info = self._reader(rel_path).info
        gt = equator_referenced_gt(info.geotransform, info.epsg)
        return ([gt[0], gt[3] + info.height * gt[5],
                 gt[0] + info.width * gt[1], gt[3]], info.epsg)
