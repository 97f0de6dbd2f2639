"""Imagery catalog interface and the synthetic backend.

``search`` returns scene metadata (date, cloud fraction); ``load``
materialises a (S, H, W, B) stack + (S, H, W) validity mask on a
tile's geocontext. Backends: LocalCatalog (GeoTIFF scenes on local disk
behind a JSON manifest, resampled onto the tile grid with any of the
five resamplers, across UTM zones) and SyntheticCatalog (procedural
scenes for tests and benchmarks). The remote catalogs (STAC, HTTP) are
ROADMAP queue 1 item 3."""

from .base import (Catalog, SceneMeta, RESAMPLERS, get_default_catalog,
                   set_default_catalog, validate_resampler)
from .local import LocalCatalog
from .synthetic import SyntheticCatalog

__all__ = [
    "Catalog", "LocalCatalog", "SceneMeta", "RESAMPLERS", "SyntheticCatalog",
    "get_default_catalog", "set_default_catalog", "validate_resampler",
]
