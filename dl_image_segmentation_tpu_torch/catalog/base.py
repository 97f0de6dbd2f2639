"""Catalog interface + default-catalog registry."""

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
    root, not ported yet); error otherwise."""
    if _default is not None:
        return _default
    if os.environ.get("DLSEG_CATALOG"):
        raise NotImplementedError(
            "$DLSEG_CATALOG names a LocalCatalog root, and LocalCatalog "
            "is not ported yet (it comes with the catalog/resampling "
            "slice); call set_default_catalog(...) instead")
    raise RuntimeError(
        "no catalog configured: call set_default_catalog(...)")


RESAMPLERS = ("near", "bilinear", "cubic", "cubicspline", "lanczos")


def validate_resampler(name: str) -> None:
    """Reject unknown resampler names with one shared message (used by
    every entry point that accepts the reference's ``resampler``
    argument, _descartes_img_chips.py:483, 512-513)."""
    if name not in RESAMPLERS:
        raise ValueError(f"unknown resampler {name!r} "
                         f"(expected one of {', '.join(map(repr, RESAMPLERS))})")
