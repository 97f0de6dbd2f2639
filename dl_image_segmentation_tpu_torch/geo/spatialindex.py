"""Uniform bbox-grid spatial index over vector features.

The reference leaned on GDAL's internal spatial filtering when burning
labels (`gdal.RasterizeLayer`, _descartes_img_chips.py:682-685 — OGR
layers carry an index); the rebuild's per-tile label projection
previously walked EVERY feature of the layer for EVERY tile, an
O(features × tiles) export cost the docstring itself flagged at the
10^5-features/68-px-tile scale. This grid makes the per-tile cost
O(candidates): features bucketed once by lon/lat bbox into a uniform
cell grid sized ~``target_per_cell`` features per cell, queried with a
tile's bbox.

A uniform grid (not an R-tree) is deliberate: label layers are
building/field footprints — small, densely and evenly packed — where a
grid's O(1) cell arithmetic beats tree traversal and builds in one
vectorized pass.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["BBoxGrid", "feature_bboxes"]


def feature_bboxes(features: Sequence) -> np.ndarray:
    """(N, 4) [minx, miny, maxx, maxy] per feature (over all rings of
    all polygons). Features with no coordinates get an empty bbox that
    never matches a query."""
    out = np.empty((len(features), 4), np.float64)
    for i, f in enumerate(features):
        minx = miny = np.inf
        maxx = maxy = -np.inf
        for rings in f.geometry.polygons():
            for r in rings:
                if len(r) == 0:
                    continue
                minx = min(minx, float(r[:, 0].min()))
                maxx = max(maxx, float(r[:, 0].max()))
                miny = min(miny, float(r[:, 1].min()))
                maxy = max(maxy, float(r[:, 1].max()))
        out[i] = (minx, miny, maxx, maxy)
    return out


class BBoxGrid:
    def __init__(self, bboxes: np.ndarray, target_per_cell: int = 8):
        self.bboxes = np.asarray(bboxes, np.float64)
        n = len(self.bboxes)
        finite = np.isfinite(self.bboxes).all(axis=1)
        idx = np.nonzero(finite)[0]
        if len(idx) == 0:
            self.nx = self.ny = 1
            self.x0 = self.y0 = 0.0
            self.dx = self.dy = 1.0
            self._cells: List[np.ndarray] = [np.empty(0, np.int64)]
            return
        b = self.bboxes[idx]
        self.x0 = float(b[:, 0].min())
        self.y0 = float(b[:, 1].min())
        x1 = float(b[:, 2].max())
        y1 = float(b[:, 3].max())
        k = max(1, int(np.sqrt(max(n, 1) / max(target_per_cell, 1))))
        self.nx = self.ny = k
        self.dx = max((x1 - self.x0) / k, 1e-12)
        self.dy = max((y1 - self.y0) / k, 1e-12)
        # cell spans per feature (features usually land in one cell)
        cx0 = np.clip(((b[:, 0] - self.x0) / self.dx).astype(np.int64),
                      0, k - 1)
        cx1 = np.clip(((b[:, 2] - self.x0) / self.dx).astype(np.int64),
                      0, k - 1)
        cy0 = np.clip(((b[:, 1] - self.y0) / self.dy).astype(np.int64),
                      0, k - 1)
        cy1 = np.clip(((b[:, 3] - self.y0) / self.dy).astype(np.int64),
                      0, k - 1)
        single = (cx0 == cx1) & (cy0 == cy1)
        buckets: List[List[int]] = [[] for _ in range(k * k)]
        # vectorized path for the dominant single-cell case
        cell_of = cy0[single] * k + cx0[single]
        order = np.argsort(cell_of, kind="stable")
        ids = idx[single][order]
        cells_sorted = cell_of[order]
        starts = np.searchsorted(cells_sorted,
                                 np.arange(k * k, dtype=np.int64))
        ends = np.searchsorted(cells_sorted,
                               np.arange(1, k * k + 1, dtype=np.int64))
        multi = np.nonzero(~single)[0]
        for j in multi:  # rare: features spanning cells
            fid = idx[j]
            for cy in range(cy0[j], cy1[j] + 1):
                for cx in range(cx0[j], cx1[j] + 1):
                    buckets[cy * k + cx].append(int(fid))
        self._cells = []
        for c in range(k * k):
            arr = ids[starts[c]:ends[c]]
            if buckets[c]:
                arr = np.sort(np.concatenate(
                    [arr, np.asarray(buckets[c], np.int64)]))
            self._cells.append(np.asarray(arr, np.int64))

    def query(self, minx: float, miny: float, maxx: float, maxy: float
              ) -> np.ndarray:
        """Indices (ascending — preserving the layer's feature order,
        which last-writer-wins burning depends on) of features whose
        bbox intersects the query bbox."""
        cx0 = int(np.clip((minx - self.x0) / self.dx, 0, self.nx - 1))
        cx1 = int(np.clip((maxx - self.x0) / self.dx, 0, self.nx - 1))
        cy0 = int(np.clip((miny - self.y0) / self.dy, 0, self.ny - 1))
        cy1 = int(np.clip((maxy - self.y0) / self.dy, 0, self.ny - 1))
        parts = [self._cells[cy * self.nx + cx]
                 for cy in range(cy0, cy1 + 1)
                 for cx in range(cx0, cx1 + 1)]
        cand = np.unique(np.concatenate(parts)) if parts \
            else np.empty(0, np.int64)
        if len(cand) == 0:
            return cand
        b = self.bboxes[cand]
        hit = ((b[:, 0] <= maxx) & (b[:, 2] >= minx)
               & (b[:, 1] <= maxy) & (b[:, 3] >= miny))
        return cand[hit]
