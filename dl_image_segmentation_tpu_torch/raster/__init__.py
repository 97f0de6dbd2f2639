"""Raster codecs for chip writing: GeoTIFF encoder (LZW, tiled, geo
tags) and the TIFF-LZW encoder."""

from .geotiff import encode_geotiff, write_geotiff

__all__ = ["encode_geotiff", "write_geotiff"]
