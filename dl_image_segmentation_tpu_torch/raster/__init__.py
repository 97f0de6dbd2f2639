"""Raster codecs: GeoTIFF reader and chip writer (LZW, tiled, geo tags),
the TIFF-LZW codec, the PNG, JPEG, GIF and BMP codecs, and the
decode-from-bytes dispatch (``raster/image.py``)."""

from .geotiff import (GeoTIFF, RasterInfo, decode_geotiff,
                      decode_geotiff_info, encode_geotiff, read_geotiff,
                      write_geotiff)

__all__ = ["GeoTIFF", "RasterInfo", "decode_geotiff", "decode_geotiff_info",
           "encode_geotiff", "read_geotiff", "write_geotiff"]
