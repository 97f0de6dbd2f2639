"""STACCatalog: SpatioTemporal Asset Catalog client (static + API).

A copy of the JAX package's ``catalog/stac.py``. The reference's chip
engine was a client of the proprietary Descartes Labs scene service
(``_descartes_img_chips.py:512-513, 612, 626``). STAC is that service
model's open standard successor — the catalog format Sentinel-2,
Landsat, NAIP and most public EO archives publish today — so this
backend lets the same chip pipeline pull imagery from any STAC
endpoint:

* **STAC API** roots (a ``rel="search"`` link or item-search
  conformance class): searches run server-side via ``POST /search``
  with ``collections``/``bbox``/``datetime``, following paged
  ``rel="next"`` links;
* **static catalogs** (``catalog.json`` trees): ``child``/``item``
  links are walked once and filtered client-side; a bare
  ItemCollection (FeatureCollection) document works too.

Mapping onto the Catalog interface: collections are products; items
are scenes (``properties.datetime``, ``eo:cloud_cover`` percent →
cloud_fraction); assets are COG GeoTIFFs read WINDOWED over HTTP
ranges (raster/cog.py) — only the internal tiles a chip touches move.
Bands resolve per item: an asset keyed by the band name, or any asset
whose ``eo:bands`` carries the name/common_name (so both
band-per-asset layouts like Sentinel-2 L2A and single multi-band
assets work, at mixed per-asset resolutions). ``processing_level``
filters on the items' ``processing:level`` property when present.

Transient failures retry with bounded backoff inside every request
(storage.gcs.http_request); persistent failure raises into the chip
layer's (job, None, None) protocol (reference :589-593, 718-722).
"""

from __future__ import annotations

import datetime as _dt
import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import urljoin

import numpy as np

from ..raster.cog import CogReader
from ..storage.gcs import http_request
from .base import Catalog, SceneMeta, load_scene_window, \
    validate_resampler

__all__ = ["STACCatalog"]

_MAX_PAGES = 200


def _iso_date(s: str) -> _dt.date:
    return _dt.datetime.fromisoformat(s.replace("Z", "+00:00")).date()


def _tile_lonlat_bbox(tile) -> List[float]:
    """The tile's padded bounds as a WGS84 [w, s, e, n] bbox."""
    from ..geo import crs as _crs
    return list(_crs.utm_bounds_to_lonlat_bbox(tile.bounds, tile.zone))


def _bbox_intersects(a: Sequence[float], b: Sequence[float]) -> bool:
    return not (a[2] < b[0] or a[0] > b[2] or a[3] < b[1] or a[1] > b[3])


class STACCatalog(Catalog):
    """See module docstring. Thread-safe: readers are created once per
    asset href and shared; windowed reads are stateless."""

    def __init__(self, url: str,
                 processing_level: Optional[str] = None,
                 max_attempts: int = 5, cache_readers: int = 32,
                 timeout: float = 60.0, token: Optional[str] = None):
        if url.startswith("stac+"):
            url = url[len("stac+"):]
        self.url = url
        self.processing_level = processing_level
        self.max_attempts = max_attempts
        self.timeout = timeout
        # bearer auth for commercial STAC APIs; $STAC_AUTH_TOKEN is the
        # non-invasive default (mirrors the GCS client's GCS_OAUTH_TOKEN)
        import os
        self.token = token if token is not None \
            else os.environ.get("STAC_AUTH_TOKEN")
        self._lock = threading.Lock()
        self._readers: Dict[str, CogReader] = {}
        self._reader_order: List[str] = []
        self._cache_max = cache_readers
        self._collections: Dict[str, dict] = {}
        self._static_items: Optional[Dict[str, List[dict]]] = None
        self._search_url: Optional[str] = None
        root = self._get_json(url)
        kind = root.get("type")
        if kind == "FeatureCollection":
            # a bare ItemCollection document IS the whole catalog
            self._static_items = {}
            for it in root.get("features", []):
                it.setdefault("_doc_url", url)
                cid = it.get("collection", "default")
                self._static_items.setdefault(cid, []).append(it)
                self._collections.setdefault(cid, {"id": cid})
            return
        for link in root.get("links", []):
            if link.get("rel") == "search":
                self._search_url = urljoin(url, link["href"])
        conforms = root.get("conformsTo") or []
        if self._search_url is None and any(
                "item-search" in c for c in conforms):
            self._search_url = urljoin(url, "search")
        if self._search_url is not None:
            # API mode: collections come from /collections when the
            # endpoint serves it; child links otherwise
            try:
                doc = self._get_json(urljoin(url + "/", "collections"))
                for c in doc.get("collections", []):
                    self._collections[c["id"]] = c
            except FileNotFoundError:
                for link in root.get("links", []):
                    if link.get("rel") == "child":
                        c = self._get_json(urljoin(url, link["href"]))
                        if c.get("type") == "Collection":
                            self._collections[c["id"]] = c
        else:
            self._walk_static(root, url)

    # -- transport --------------------------------------------------------
    def _request(self, method: str, abs_url: str,
                 headers: Optional[dict] = None,
                 body: Optional[bytes] = None) -> Tuple[int, bytes]:
        hdrs = dict(headers or {})
        if self.token:
            hdrs.setdefault("Authorization", f"Bearer {self.token}")
        status, data, _ = http_request(
            method, abs_url, data=body, headers=hdrs,
            ok_statuses=(200, 206), max_attempts=self.max_attempts,
            timeout=self.timeout)
        return status, data

    def _get_json(self, abs_url: str) -> dict:
        status, data = self._request("GET", abs_url)
        if status == 404:
            raise FileNotFoundError(abs_url)
        return json.loads(data)

    def _fetch_range(self, abs_url: str, start: int, length: int
                     ) -> bytes:
        status, body = self._request(
            "GET", abs_url,
            headers={"Range": f"bytes={start}-{start + length - 1}"})
        if status == 404:
            raise FileNotFoundError(abs_url)
        if status == 416:
            return b""
        if status == 200 and start:
            return body[start:start + length]  # Range-ignoring server
        return body

    # -- static tree walk -------------------------------------------------
    def _walk_static(self, root: dict, doc_url: str) -> None:
        self._static_items = {}
        seen = set()
        frontier = [(root, doc_url)]
        while frontier:
            doc, base = frontier.pop()
            kind = doc.get("type")
            if kind == "Collection":
                self._collections[doc["id"]] = doc
            if kind == "Feature":
                doc.setdefault("_doc_url", base)
                cid = doc.get("collection") or "default"
                self._static_items.setdefault(cid, []).append(doc)
                self._collections.setdefault(cid, {"id": cid})
                continue
            for link in doc.get("links", []):
                if link.get("rel") not in ("child", "item"):
                    continue
                href = urljoin(base, link["href"])
                if href in seen:
                    continue
                seen.add(href)
                frontier.append((self._get_json(href), href))

    # -- Catalog interface --------------------------------------------------
    def products(self) -> List[str]:
        return sorted(self._collections)

    def bands(self, product: str) -> List[str]:
        """Band names from the collection's ``summaries['eo:bands']``
        or ``item_assets``; falls back to the first item's data
        assets."""
        col = self._collections.get(product)
        if col is None:
            raise KeyError(f"unknown STAC collection {product!r}")
        ebs = (col.get("summaries") or {}).get("eo:bands")
        if ebs:
            return [b["name"] for b in ebs]
        out: List[str] = []
        for key, a in sorted((col.get("item_assets") or {}).items()):
            for b in a.get("eo:bands", []):
                if b["name"] not in out:
                    out.append(b["name"])
        if out or self._static_items is None:
            return out
        for it in self._static_items.get(product, [])[:1]:
            for key, a in sorted(it.get("assets", {}).items()):
                for b in a.get("eo:bands", [{"name": key}]):
                    if b["name"] not in out:
                        out.append(b["name"])
        return out

    def search(self, tile, product: str,
               start: Optional[_dt.date] = None,
               end: Optional[_dt.date] = None,
               max_cloud_fraction: Optional[float] = None,
               processing_level: Optional[str] = None
               ) -> List[SceneMeta]:
        bbox = _tile_lonlat_bbox(tile)
        level = processing_level if processing_level is not None \
            else self.processing_level
        if self._static_items is not None:
            items = self._static_items.get(product, [])
        else:
            items = self._api_search(product, bbox, start, end)
        out = []
        for it in items:
            props = it.get("properties", {})
            dts = props.get("datetime") or props.get("start_datetime")
            if not dts:
                continue
            date = _iso_date(dts)
            if start is not None and date < start:
                continue
            if end is not None and date > end:
                continue
            cc = props.get("eo:cloud_cover")
            cf = None if cc is None else float(cc) / 100.0
            if max_cloud_fraction is not None and cf is not None \
                    and not (cf < max_cloud_fraction):
                continue
            if level is not None:
                have = props.get("processing:level")
                if have is not None and have != level:
                    continue
            ib = it.get("bbox")
            if ib is not None and not _bbox_intersects(ib, bbox):
                continue
            out.append(SceneMeta(
                it["id"], product, date, cf,
                path=it.get("_doc_url"), extra={"item": it}))
        out.sort(key=lambda m: m.date)
        return out

    def _api_search(self, product: str, bbox: List[float],
                    start: Optional[_dt.date], end: Optional[_dt.date]
                    ) -> List[dict]:
        body = {"collections": [product], "bbox": bbox, "limit": 100}
        if start or end:
            body["datetime"] = "{}/{}".format(
                start.isoformat() + "T00:00:00Z" if start else "..",
                end.isoformat() + "T23:59:59Z" if end else "..")
        url, method = self._search_url, "POST"
        items: List[dict] = []
        for _ in range(_MAX_PAGES):
            status, data = self._request(
                method, url,
                headers={"Content-Type": "application/json"},
                body=json.dumps(body).encode() if method == "POST"
                else None)
            if status == 404:
                raise FileNotFoundError(url)
            page = json.loads(data)
            for it in page.get("features", []):
                it.setdefault("_doc_url", url)
                items.append(it)
            nxt = next((l for l in page.get("links", [])
                        if l.get("rel") == "next"), None)
            if nxt is None:
                return items
            url = urljoin(url, nxt["href"])
            method = nxt.get("method", "GET")
            body = nxt.get("body", {})
        raise RuntimeError(
            f"STAC search exceeded {_MAX_PAGES} result pages")

    def load(self, scenes: Sequence[SceneMeta], tile,
             bands: Sequence[str], resampler: str = "near"
             ) -> Tuple[np.ndarray, np.ndarray]:
        validate_resampler(resampler)
        stacks, valids = [], []
        for m in scenes:
            item = m.extra["item"]
            base = item.get("_doc_url") or self.url
            # group requested bands by the asset that carries them so
            # each asset is window-read once
            per_asset: Dict[str, List[Tuple[int, int]]] = {}
            hrefs: Dict[str, dict] = {}
            for out_idx, band in enumerate(bands):
                href, src_idx, asset = self._resolve_band(
                    item, band, base)
                per_asset.setdefault(href, []).append(
                    (out_idx, src_idx))
                hrefs[href] = asset
            n = tile.raster_size
            valid = np.ones((n, n), bool)
            wins: List[Tuple[List[Tuple[int, int]], np.ndarray]] = []
            for href, mapping in per_asset.items():
                reader = self._reader(href)
                info = reader.info
                nodata = self._asset_nodata(hrefs[href], info)
                sel = [src for _, src in mapping]
                win, v = load_scene_window(reader, info, tile, sel,
                                           nodata, resampler)
                wins.append((mapping, win))
                valid &= v
            # assemble under the PROMOTED dtype across assets — a
            # uint8 SCL asset next to a uint16 reflectance asset must
            # widen, not silently wrap the wider values
            out = np.zeros((n, n, len(bands)),
                           np.result_type(*(w.dtype for _, w in wins))
                           if wins else np.float32)
            for mapping, win in wins:
                for k, (out_idx, _) in enumerate(mapping):
                    out[:, :, out_idx] = win[:, :, k]
            stacks.append(out)
            valids.append(valid)
        if not stacks:
            n = tile.raster_size
            return (np.zeros((0, n, n, len(bands)), np.float32),
                    np.zeros((0, n, n), bool))
        return np.stack(stacks), np.stack(valids)

    @staticmethod
    def _resolve_band(item: dict, band: str, base: str
                      ) -> Tuple[str, int, dict]:
        """(absolute asset href, band index within the asset, asset
        dict) for a requested band name."""
        assets = item.get("assets", {})
        a = assets.get(band)
        if a is not None:
            return urljoin(base, a["href"]), 0, a
        for key, a in assets.items():
            for i, eb in enumerate(a.get("eo:bands", [])):
                if band in (eb.get("name"), eb.get("common_name")):
                    return urljoin(base, a["href"]), i, a
        raise ValueError(
            f"STAC item {item.get('id')!r} has no asset carrying band "
            f"{band!r} (assets: {sorted(assets)})")

    @staticmethod
    def _asset_nodata(asset: dict, info) -> Optional[float]:
        rb = asset.get("raster:bands")
        if rb and rb[0].get("nodata") is not None:
            return float(rb[0]["nodata"])
        if asset.get("nodata") is not None:
            return float(asset["nodata"])
        return info.nodata

    def _reader(self, href: str) -> CogReader:
        with self._lock:
            r = self._readers.get(href)
            if r is not None:
                return r
        r = CogReader(lambda s, ln, u=href: self._fetch_range(u, s, ln))
        with self._lock:
            if href not in self._readers:
                self._readers[href] = r
                self._reader_order.append(href)
                if len(self._reader_order) > self._cache_max:
                    self._readers.pop(self._reader_order.pop(0), None)
            return self._readers[href]
