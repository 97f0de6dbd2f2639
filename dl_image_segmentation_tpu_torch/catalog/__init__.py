"""Imagery catalog interface and its backends.

``search`` returns scene metadata (date, cloud fraction); ``load``
materialises a (S, H, W, B) stack + (S, H, W) validity mask on a
tile's geocontext. Backends: LocalCatalog (GeoTIFF scenes behind a JSON
manifest on local disk, gs://, s3:// or http(s)://, resampled onto the
tile grid with any of the five resamplers, across UTM zones),
HTTPCatalog (a remote scene server: the LocalCatalog index over HTTP
with COG windowed reads and retries; fixture: catalog/httpserver.py),
STACCatalog (static STAC trees and item-search APIs; fixture:
catalog/stacserver.py) and SyntheticCatalog (procedural scenes for
tests and benchmarks)."""

from .base import (Catalog, SceneMeta, RESAMPLERS, get_default_catalog,
                   set_default_catalog, validate_resampler)
from .http import HTTPCatalog
from .local import LocalCatalog
from .stac import STACCatalog
from .synthetic import SyntheticCatalog

__all__ = [
    "Catalog", "HTTPCatalog", "LocalCatalog", "SceneMeta", "RESAMPLERS",
    "STACCatalog", "SyntheticCatalog", "get_default_catalog",
    "set_default_catalog", "validate_resampler",
]
