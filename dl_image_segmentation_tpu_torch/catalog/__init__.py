"""Imagery catalog interface and the synthetic backend.

``search`` returns scene metadata (date, cloud fraction); ``load``
materialises a (S, H, W, B) stack + (S, H, W) validity mask on a
tile's geocontext. Resampling catalogs (local, STAC, HTTP) are not
ported yet."""

from .base import (Catalog, SceneMeta, RESAMPLERS, get_default_catalog,
                   set_default_catalog, validate_resampler)
from .synthetic import SyntheticCatalog

__all__ = [
    "Catalog", "SceneMeta", "RESAMPLERS", "SyntheticCatalog",
    "get_default_catalog", "set_default_catalog", "validate_resampler",
]
