"""STAC fixture server + static-tree builder.

``StacBuilder`` authors a spec-shaped static STAC tree on disk
(catalog.json -> collections -> items -> COG GeoTIFF assets), and
``StacServer`` serves it over HTTP with single-range GET support plus
a ``POST /search`` STAC-API endpoint (collections/bbox/datetime
filters, ``limit`` + ``rel="next"`` token paging), so STACCatalog's
two modes and the chip pipeline's retry protocol run on loopback, the
way catalog/httpserver.py stands in for the reference's proprietary
scene service (``_descartes_img_chips.py:512-513, 612, 626``).

A copy of the JAX package's ``catalog/stacserver.py``. In the package,
like storage/fake_gcs.py, so that ``chip_smoke.py`` and local trials
can start a STAC endpoint in two lines.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np

from .base import equator_referenced_gt, _epsg_zone

__all__ = ["StacBuilder", "StacServer"]


def _lonlat_bbox(gt, epsg, h, w) -> List[float]:
    """WGS84 [w, s, e, n] of a raster footprint."""
    from ..geo import crs as _crs
    g = equator_referenced_gt(gt, epsg)
    xs = np.array([0, w, 0, w], np.float64) * g[1] + g[0]
    ys = np.array([0, 0, h, h], np.float64) * g[5] + g[3]
    zone = _epsg_zone(epsg)
    if zone is None:
        raise ValueError(f"StacBuilder needs a UTM EPSG, got {epsg}")
    lon, lat = _crs.utm_to_lonlat(xs, ys, zone)
    return [float(np.min(lon)), float(np.min(lat)),
            float(np.max(lon)), float(np.max(lat))]


class StacBuilder:
    """Author a static STAC tree under ``root``:

        root/catalog.json
        root/collections/<cid>.json
        root/items/<item_id>.json
        root/assets/<item_id>_<asset_key>.tif
    """

    def __init__(self, root: str, catalog_id: str = "catalog"):
        self.root = os.path.abspath(root)
        for sub in ("collections", "items", "assets"):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)
        self._catalog = {
            "type": "Catalog", "stac_version": "1.0.0",
            "id": catalog_id, "description": "fixture catalog",
            "links": []}
        self._collections: Dict[str, dict] = {}
        self._flush_catalog()

    def _flush_catalog(self) -> None:
        with open(os.path.join(self.root, "catalog.json"), "w") as f:
            json.dump(self._catalog, f)

    def _flush_collection(self, cid: str) -> None:
        path = os.path.join(self.root, "collections", f"{cid}.json")
        with open(path, "w") as f:
            json.dump(self._collections[cid], f)

    def add_collection(self, cid: str,
                       bands: Optional[Sequence[str]] = None) -> None:
        col = {"type": "Collection", "stac_version": "1.0.0",
               "id": cid, "description": cid, "license": "CC0",
               "extent": {}, "links": []}
        if bands:
            col["summaries"] = {
                "eo:bands": [{"name": b} for b in bands]}
        self._collections[cid] = col
        self._catalog["links"].append(
            {"rel": "child", "href": f"collections/{cid}.json",
             "type": "application/json"})
        self._flush_catalog()
        self._flush_collection(cid)

    def add_item(self, cid: str, item_id: str, date: _dt.date,
                 assets: Dict[str, dict],
                 cloud_cover: Optional[float] = None,
                 properties: Optional[dict] = None) -> dict:
        """``assets`` values: {"array": (H,W,B), "geotransform": gt,
        "epsg": int, "eo_bands": [names...], "nodata": optional}.
        Arrays are written as tiled-capable GeoTIFFs; hrefs are
        RELATIVE to the item document (the common static layout)."""
        from ..raster.geotiff import write_geotiff
        if cid not in self._collections:
            self.add_collection(cid)
        item = {"type": "Feature", "stac_version": "1.0.0",
                "id": item_id, "collection": cid,
                "properties": {"datetime":
                               date.isoformat() + "T00:00:00Z"},
                "assets": {}, "links": [
                    {"rel": "collection",
                     "href": f"../collections/{cid}.json"}]}
        if cloud_cover is not None:
            item["properties"]["eo:cloud_cover"] = float(cloud_cover)
        if properties:
            item["properties"].update(properties)
        bbox = None
        for key, spec in assets.items():
            arr = np.asarray(spec["array"])
            rel = f"../assets/{item_id}_{key}.tif"
            write_geotiff(
                os.path.join(self.root, "assets",
                             f"{item_id}_{key}.tif"),
                arr, geotransform=tuple(spec["geotransform"]),
                epsg=int(spec["epsg"]), nodata=spec.get("nodata"))
            a = {"href": rel, "type": "image/tiff; application=geotiff",
                 "roles": ["data"]}
            if spec.get("eo_bands"):
                a["eo:bands"] = [{"name": b} for b in spec["eo_bands"]]
            if spec.get("nodata") is not None:
                a["raster:bands"] = [{"nodata": spec["nodata"]}]
            item["assets"][key] = a
            b = _lonlat_bbox(spec["geotransform"], spec["epsg"],
                             arr.shape[0], arr.shape[1])
            bbox = b if bbox is None else [
                min(bbox[0], b[0]), min(bbox[1], b[1]),
                max(bbox[2], b[2]), max(bbox[3], b[3])]
        item["bbox"] = bbox
        with open(os.path.join(self.root, "items",
                               f"{item_id}.json"), "w") as f:
            json.dump(item, f)
        self._collections[cid]["links"].append(
            {"rel": "item", "href": f"../items/{item_id}.json",
             "type": "application/geo+json"})
        self._flush_collection(cid)
        return item


class StacServer:
    """``with StacServer(root) as srv:`` serves a StacBuilder tree on
    ``srv.url``: static GETs with single-range support, plus
    ``POST /search`` (STAC API item search with token paging). When
    ``api=True`` the served catalog.json advertises a ``rel="search"``
    link so STACCatalog picks API mode; ``api=False`` serves the tree
    verbatim (static mode). ``fail_next`` injects transient failures."""

    def __init__(self, root: str, api: bool = False,
                 host: str = "127.0.0.1", port: int = 0,
                 require_token: Optional[str] = None):
        self.root = os.path.abspath(root)
        self.api = api
        self.require_token = require_token
        self.requests = 0
        self.search_requests = 0
        self.range_requests = 0
        self.bytes_served = 0
        self._fail_remaining = 0
        self._fail_status = 503
        self._lock = threading.Lock()
        srv = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, status: int, body: bytes,
                       extra: Optional[dict] = None) -> None:
                self.send_response(status)
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                with srv._lock:
                    srv.bytes_served += len(body)

            def _maybe_fail(self) -> bool:
                with srv._lock:
                    srv.requests += 1
                    if srv._fail_remaining > 0:
                        srv._fail_remaining -= 1
                        status = srv._fail_status
                    else:
                        status = 0
                if status:
                    self._reply(status, b'{"error": "injected"}')
                    return True
                if srv.require_token is not None:
                    auth = self.headers.get("Authorization", "")
                    if auth != f"Bearer {srv.require_token}":
                        self._reply(401, b'{"error": "unauthorized"}')
                        return True
                return False

            def do_GET(self):
                if self._maybe_fail():
                    return
                rel = self.path.partition("?")[0].lstrip("/")
                if rel in ("", "catalog.json"):
                    self._reply(200, srv._root_doc())
                    return
                if rel.rstrip("/") == "collections":
                    self._reply(200, srv._collections_doc())
                    return
                path = os.path.normpath(os.path.join(srv.root, rel))
                if not path.startswith(srv.root) \
                        or not os.path.isfile(path):
                    self._reply(404, b'{"error": "not found"}')
                    return
                size = os.path.getsize(path)
                start, end, status = 0, size - 1, 200
                rng = self.headers.get("Range")
                if rng:
                    m = re.fullmatch(r"bytes=(\d+)-(\d*)", rng.strip())
                    if m:
                        start = int(m.group(1))
                        if m.group(2):
                            end = min(int(m.group(2)), size - 1)
                        if start >= size:
                            self._reply(416, b"", {
                                "Content-Range": f"bytes */{size}"})
                            return
                        status = 206
                        with srv._lock:
                            srv.range_requests += 1
                with open(path, "rb") as f:
                    f.seek(start)
                    body = f.read(end - start + 1)
                extra = {"Accept-Ranges": "bytes"}
                if status == 206:
                    extra["Content-Range"] = (
                        f"bytes {start}-{start + len(body) - 1}/{size}")
                self._reply(status, body, extra)

            def do_POST(self):
                if self._maybe_fail():
                    return
                rel = self.path.partition("?")[0].rstrip("/")
                if not rel.endswith("/search"):
                    self._reply(404, b'{"error": "not found"}')
                    return
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    query = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._reply(400, b'{"error": "bad json"}')
                    return
                with srv._lock:
                    srv.search_requests += 1
                self._reply(200, srv._search(query),
                            {"Content-Type": "application/geo+json"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    # -- documents --------------------------------------------------------
    def _root_doc(self) -> bytes:
        with open(os.path.join(self.root, "catalog.json")) as f:
            doc = json.load(f)
        if self.api:
            doc = {**doc,
                   "conformsTo": [
                       "https://api.stacspec.org/v1.0.0/item-search"],
                   "links": [{"rel": "search",
                              "href": f"{self.url}/search",
                              "method": "POST"}]}
        return json.dumps(doc).encode()

    def _collections_doc(self) -> bytes:
        cols = []
        d = os.path.join(self.root, "collections")
        for name in sorted(os.listdir(d)):
            if name.endswith(".json"):
                with open(os.path.join(d, name)) as f:
                    cols.append(json.load(f))
        return json.dumps({"collections": cols}).encode()

    def _all_items(self) -> List[dict]:
        items = []
        d = os.path.join(self.root, "items")
        for name in sorted(os.listdir(d)):
            if name.endswith(".json"):
                with open(os.path.join(d, name)) as f:
                    items.append(json.load(f))
        return items

    def _search(self, query: dict) -> bytes:
        cols = query.get("collections")
        bbox = query.get("bbox")
        dts = query.get("datetime")
        limit = int(query.get("limit", 100))
        offset = int(query.get("token", 0))
        lo = hi = None
        if dts:
            lo_s, _, hi_s = dts.partition("/")
            lo = None if lo_s in ("..", "") else lo_s[:10]
            hi = None if hi_s in ("..", "") else hi_s[:10]
        hits = []
        for it in self._all_items():
            if cols and it.get("collection") not in cols:
                continue
            d = it["properties"]["datetime"][:10]
            if lo is not None and d < lo:
                continue
            if hi is not None and d > hi:
                continue
            b = it.get("bbox")
            if bbox and b and (b[2] < bbox[0] or b[0] > bbox[2]
                               or b[3] < bbox[1] or b[1] > bbox[3]):
                continue
            # asset hrefs are relative to the item document; rewrite
            # them absolute since /search responses have no stable base
            it = json.loads(json.dumps(it))
            for a in it.get("assets", {}).values():
                if a["href"].startswith("../"):
                    a["href"] = f"{self.url}/{a['href'][3:]}"
            hits.append(it)
        page = hits[offset:offset + limit]
        doc = {"type": "FeatureCollection", "features": page,
               "links": []}
        if offset + limit < len(hits):
            nxt = dict(query)
            nxt["token"] = offset + limit
            doc["links"].append({"rel": "next",
                                 "href": f"{self.url}/search",
                                 "method": "POST", "body": nxt})
        return json.dumps(doc).encode()

    # -- lifecycle --------------------------------------------------------
    @property
    def url(self) -> str:
        a = self._httpd.server_address
        return f"http://{a[0]}:{a[1]}"

    def fail_next(self, n: int, status: int = 503) -> None:
        with self._lock:
            self._fail_remaining = n
            self._fail_status = status

    def start(self) -> "StacServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "StacServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
