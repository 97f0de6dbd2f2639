"""SyntheticCatalog: procedurally generated scenes for tests + benches.

Deterministic per (product, tile, scene index): the same query always
yields the same pixels, so round-trip tests and benchmark runs are
reproducible without any fixture data on disk. Scenes get synthetic
acquisition dates spaced ``cadence_days`` apart ending at ``end_date``,
per-scene cloud fractions from a hash, and blotchy validity masks (to
exercise the masked-median path)."""

from __future__ import annotations

import datetime as _dt
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .base import Catalog, SceneMeta, validate_resampler


def _seed_for(*parts) -> int:
    h = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:4], "little")


class SyntheticCatalog(Catalog):
    def __init__(self, products: Optional[Dict[str, List[str]]] = None,
                 scenes_per_tile: int = 10,
                 end_date: _dt.date = _dt.date(2020, 12, 1),
                 cadence_days: int = 10,
                 dtype=np.uint16,
                 cloud_product: str = "sentinel-2:L1C:dlcloud:v1"):
        self._products = products or {
            "sentinel-2:L1C": ["coastal-aerosol", "blue", "green", "red",
                               "red-edge", "red-edge-2", "red-edge-3",
                               "nir", "red-edge-4", "water-vapor",
                               "cirrus", "swir1", "swir2"],
            "airbus:oneatlas:phr:v2": ["red", "green", "blue"],
            cloud_product: ["valid_cloudfree"],
        }
        self.scenes_per_tile = scenes_per_tile
        self.end_date = end_date
        self.cadence_days = cadence_days
        self.dtype = dtype
        self.cloud_product = cloud_product

    def products(self) -> List[str]:
        return list(self._products)

    def bands(self, product: str) -> List[str]:
        return list(self._products[product])

    def search(self, tile, product: str,
               start: Optional[_dt.date] = None,
               end: Optional[_dt.date] = None,
               max_cloud_fraction: Optional[float] = None
               ) -> List[SceneMeta]:
        if product not in self._products:
            return []
        out = []
        for i in range(self.scenes_per_tile):
            date = self.end_date - _dt.timedelta(
                days=self.cadence_days * (self.scenes_per_tile - 1 - i))
            if start is not None and date < start:
                continue
            if end is not None and date > end:
                continue
            cf = (_seed_for(product, tile.key, i, "cf") % 1000) / 1000.0
            if max_cloud_fraction is not None and not (cf < max_cloud_fraction):
                continue
            out.append(SceneMeta(f"{product}#{tile.key}#{i}", product, date,
                                 cf, extra={"index": i}))
        return out

    def load(self, scenes: Sequence[SceneMeta], tile,
             bands: Sequence[str], resampler: str = "near"
             ) -> Tuple[np.ndarray, np.ndarray]:
        # scenes are generated directly on the tile grid, so "near"
        # and "bilinear" coincide; still reject unknown values so a
        # caller's typo fails the same way as on LocalCatalog
        validate_resampler(resampler)
        n = tile.raster_size
        stacks = []
        valids = []
        for m in scenes:
            rng = np.random.RandomState(_seed_for(m.scene_id, "pix"))
            if m.product == self.cloud_product:
                # binary mask band: blotches of cloud (0) over valid (1)
                base = rng.rand(n // 8 + 1, n // 8 + 1)
                up = np.kron(base, np.ones((8, 8)))[:n, :n]
                arr = (up > 0.35).astype(np.uint8)[:, :, None]
                arr = np.repeat(arr, len(bands), axis=2)
                valid = np.ones((n, n), bool)
            else:
                band_idx = [self.bands(m.product).index(b) for b in bands]
                # smooth-ish synthetic imagery: per-band ramps + noise
                yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
                arr = np.stack([
                    (xx * (bi + 1) + yy + rng.rand() * 500
                     + rng.randn(n, n) * 8) % 4096
                    for bi in band_idx], axis=-1).astype(self.dtype)
                # blotchy validity (swath edges / missing data)
                base = rng.rand(n // 16 + 1, n // 16 + 1)
                up = np.kron(base, np.ones((16, 16)))[:n, :n]
                valid = up > 0.15
            stacks.append(arr)
            valids.append(valid)
        if not stacks:
            return (np.zeros((0, n, n, len(bands)), np.float32),
                    np.zeros((0, n, n), bool))
        return np.stack(stacks), np.stack(valids)
