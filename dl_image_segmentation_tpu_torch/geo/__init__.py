"""Geo core for chip creation: tile grid math, CRS transforms, geometry,
vector IO and the feature spatial index (copies of the JAX package's
framework-free modules, so the port imports nothing of that package)."""

from .tilegrid import Tile, tiles_from_shape, tiles_from_bounds_utm
from .geometry import Geometry, points_in_polygon, polygon_intersects_rect
from .vector import VectorDataset, VectorLayer, Feature, open_vector
from . import crs

__all__ = [
    "Tile", "tiles_from_shape", "tiles_from_bounds_utm", "Geometry",
    "points_in_polygon", "polygon_intersects_rect", "VectorDataset",
    "VectorLayer", "Feature", "open_vector", "crs",
]
