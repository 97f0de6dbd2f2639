"""Windowed (COG-style) GeoTIFF reading over a ranged-byte source.

The reference's chip engine asked a remote server for exactly the
pixels of one tile's geocontext (`_descartes_img_chips.py:612, 626` —
the Descartes Labs backend windowed server-side). With plain COG-style
scene files on an HTTP server or object store, the client must do that
windowing itself: parse the TIFF structure from a small header fetch,
work out which internal tiles/strips intersect the requested window,
and range-GET only those byte ranges (coalescing near-adjacent ones).
A 10,000² scene serving a 260² tile window then moves a few hundred
KB instead of hundreds of MB — the difference between a catalog that
scales to pod-sized exports and one that re-downloads the world per
tile.

Layout/compression support is inherited from the main codec
(raster/geotiff.py `_Layout`): strip or tile organization, LZW /
Deflate / PackBits / none, predictor 1/2/3, planar 1/2, classic and
BigTIFF.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from .geotiff import (RasterInfo, _geo_info_from_tags, _Layout,
                      _parse_ifd)

__all__ = ["CogReader", "RangeFetch"]

# fetch(start, length) -> bytes (short only at EOF)
RangeFetch = Callable[[int, int], bytes]

_INITIAL_HEADER = 64 * 1024
_MAX_HEADER = 16 * 1024 * 1024
_MERGE_GAP = 64 * 1024  # coalesce ranges closer than this


class CogReader:
    """One remote GeoTIFF behind a ranged-fetch callable.

    The header (IFD + tag arrays, incl. tile offset tables) is fetched
    once, growing geometrically while the parse still runs off the end
    of the prefix; pixel reads then touch only the byte ranges of
    intersecting chunks. Stateless between read_window calls apart
    from the parsed header, so one reader serves concurrent tiles.
    """

    def __init__(self, fetch: RangeFetch,
                 initial_header: int = _INITIAL_HEADER):
        self._fetch = fetch
        self._buf = b""
        self._need = initial_header
        self._layout: Optional[_Layout] = None
        self._parse_header()

    # -- header ---------------------------------------------------------
    def _parse_header(self) -> None:
        while True:
            at_eof = False
            if len(self._buf) < self._need:
                want = self._need - len(self._buf)
                more = self._fetch(len(self._buf), want)
                self._buf += more
                at_eof = len(more) < want
            try:
                fmt, tags = _parse_ifd(self._buf)
                self._layout = _Layout(fmt, tags)
                self._fmt, self._tags = fmt, tags
                return
            except ValueError as e:
                # "not a TIFF" never heals by fetching more; every
                # other parse failure may just mean a tag offset past
                # the current prefix
                if str(e) == "not a TIFF" and len(self._buf) >= 8:
                    raise
            except Exception:  # noqa: BLE001 -- short-buffer symptom
                pass
            if at_eof or self._need >= _MAX_HEADER:
                raise ValueError(
                    "could not parse TIFF header within "
                    f"{self._need} bytes (malformed file, or metadata "
                    "beyond the header-growth cap)")
            self._need *= 2

    @property
    def layout(self) -> _Layout:
        assert self._layout is not None
        return self._layout

    @property
    def info(self) -> RasterInfo:
        lay = self.layout
        info = RasterInfo(width=lay.width, height=lay.height,
                          count=lay.spp, dtype=np.dtype(lay.dtype).name)
        _geo_info_from_tags(self._tags, info)
        return info

    # -- windowed read ----------------------------------------------------
    def read_window(self, y0: int, x0: int, y1: int, x1: int
                    ) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Pixels of the half-open window [y0:y1, x0:x1], CLIPPED to
        the image. Returns (array (h, w, bands) native dtype,
        (clip_y0, clip_x0)) — the actual origin after clipping. An
        empty intersection returns a (0, 0, bands) array."""
        lay = self.layout
        y0c, x0c = max(0, y0), max(0, x0)
        y1c, x1c = min(lay.height, y1), min(lay.width, x1)
        if y0c >= y1c or x0c >= x1c:
            return (np.zeros((0, 0, lay.spp), lay.dtype), (y0c, x0c))
        h, w = y1c - y0c, x1c - x0c
        out = np.zeros((lay.nplanes, h, w, lay.samples_per_px), lay.dtype)

        # chunk index -> (plane, chunk row/col geometry)
        needed: List[Tuple[int, int, int, int]] = []  # (idx, plane, cj, ci)
        if lay.tiled:
            tj0, tj1 = y0c // lay.tile_h, (y1c - 1) // lay.tile_h
            ti0, ti1 = x0c // lay.tile_w, (x1c - 1) // lay.tile_w
            per_plane = lay.tiles_down * lay.tiles_across
            for plane in range(lay.nplanes):
                for tj in range(tj0, tj1 + 1):
                    for ti in range(ti0, ti1 + 1):
                        needed.append((plane * per_plane
                                       + tj * lay.tiles_across + ti,
                                       plane, tj, ti))
        else:
            rps = lay.rows_per_strip
            sj0, sj1 = y0c // rps, (y1c - 1) // rps
            strips_per_plane = -(-lay.height // rps)
            for plane in range(lay.nplanes):
                for sj in range(sj0, sj1 + 1):
                    needed.append((plane * strips_per_plane + sj,
                                   plane, sj, 0))

        raw = self._fetch_chunks([i for i, _p, _j, _i in needed
                                  if lay.counts[i] > 0])
        for (idx, plane, cj, ci) in needed:
            if lay.counts[idx] == 0:
                # sparse COG (GDAL SPARSE_OK): offset=0/count=0 marks
                # an all-fill chunk — leave the zeros in place
                continue
            data = raw[idx]
            if lay.tiled:
                cy0, cx0 = cj * lay.tile_h, ci * lay.tile_w
                nrows, ncols = lay.tile_h, lay.tile_w
            else:
                cy0, cx0 = cj * lay.rows_per_strip, 0
                nrows = min(lay.rows_per_strip, lay.height - cy0)
                ncols = lay.width
            arr = lay.decode_chunk(data, nrows, ncols)
            # intersect chunk extent with the clipped window
            ry0, ry1 = max(cy0, y0c), min(cy0 + nrows, y1c)
            rx0, rx1 = max(cx0, x0c), min(cx0 + ncols, x1c)
            out[plane, ry0 - y0c:ry1 - y0c, rx0 - x0c:rx1 - x0c] = \
                arr[ry0 - cy0:ry1 - cy0, rx0 - cx0:rx1 - cx0]
        if lay.planar == 2:
            res = np.moveaxis(out[:, :, :, 0], 0, -1)
        else:
            res = out[0]
        res = np.ascontiguousarray(res)
        if lay.fmt == ">":
            res = res.astype(res.dtype.newbyteorder("="))
        return res, (y0c, x0c)

    def read_full(self) -> np.ndarray:
        arr, _ = self.read_window(0, 0, self.layout.height,
                                  self.layout.width)
        return arr

    def _fetch_chunks(self, indices: List[int]) -> dict:
        """Fetch the byte ranges of the given chunk indices with
        nearby ranges coalesced into one request (HTTP round-trips
        dominate at chip-window sizes)."""
        lay = self.layout
        spans = sorted((lay.offsets[i], lay.counts[i], i)
                       for i in set(indices))
        out: dict = {}
        k = 0
        while k < len(spans):
            start = spans[k][0]
            end = spans[k][0] + spans[k][1]
            group = [spans[k]]
            k += 1
            while k < len(spans) and spans[k][0] - end <= _MERGE_GAP:
                end = max(end, spans[k][0] + spans[k][1])
                group.append(spans[k])
                k += 1
            # serve from the header prefix when already resident
            if end <= len(self._buf):
                blob = self._buf[start:end]
            else:
                blob = self._fetch(start, end - start)
            for off, cnt, idx in group:
                out[idx] = blob[off - start:off - start + cnt]
        return out
