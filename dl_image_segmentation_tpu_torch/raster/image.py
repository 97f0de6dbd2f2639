"""Decode-from-bytes dispatch for the server's request bodies.

The JAX package's ``raster/image.py`` sniffs a container from its magic
bytes and decodes any supported raster. The port decodes TIFF/GeoTIFF
(classic and BigTIFF) with its own reader (``raster/geotiff.py``).
Other containers raise :class:`UnsupportedFormatError` naming the
detected format: PNG, JPEG, BMP and GIF are decoded with PIL in the JAX
package, and the port does not depend on PIL; the scientific formats
come with later slices.
"""

from __future__ import annotations

from .geotiff import GeoTIFF, RasterInfo, decode_geotiff, decode_geotiff_info

__all__ = ["CorruptRasterError", "UnsupportedFormatError",
           "decode_image_bytes", "sniff_image_info"]


class UnsupportedFormatError(ValueError):
    """Raised when bytes are a container this port does not decode; the
    message names the detected format."""


class CorruptRasterError(ValueError):
    """A recognised container failed to parse or decode; the message
    names the format."""


def _named(fmt: str, fn, *args, **kwargs):
    """Run a container decoder, wrapping its failures with the format
    name; the original message is preserved for substring matching."""
    try:
        return fn(*args, **kwargs)
    except (CorruptRasterError, UnsupportedFormatError):
        raise
    except Exception as e:
        raise CorruptRasterError(
            f"corrupt or unreadable {fmt} container; "
            f"{type(e).__name__}: {e}") from e


# (magic, name, ROADMAP queue 1 item that ports its decoder): item 6 is
# what the JAX package decodes through PIL or OpenJPEG, item 10 the
# scientific containers of its universal decode
_KNOWN_MAGICS = (
    (b"\x89PNG\r\n\x1a\n", "PNG", 6),
    (b"\xff\xd8\xff", "JPEG", 6),
    (b"GIF8", "GIF", 6),
    (b"BM", "BMP", 6),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000 (JP2)", 6),
    (b"\xffO\xffQ", "JPEG 2000 codestream (J2K)", 6),
    (b"CDF\x01", "NetCDF classic", 10),
    (b"CDF\x02", "NetCDF classic", 10),
    (b"CDF\x05", "NetCDF classic", 10),
    (b"\x89HDF\r\n\x1a\n", "HDF5 / NetCDF-4", 10),
    (b"\x0e\x03\x13\x01", "HDF4", 10),
    (b"GRIB", "GRIB", 10),
    (b"NITF", "NITF", 10),
    (b"SQLite format 3\x00", "GeoPackage (SQLite)", 10),
)


def _is_tiff(data: bytes) -> bool:
    # classic TIFF (version 42) or BigTIFF (version 43)
    return data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")


def _unsupported(data: bytes) -> UnsupportedFormatError:
    name, item = next(((n, i) for magic, n, i in _KNOWN_MAGICS
                       if data[:len(magic)] == magic),
                      (f"unknown container (magic bytes {data[:4]!r})", 10))
    return UnsupportedFormatError(
        f"unsupported raster format: {name}. The port decodes GeoTIFF "
        "(classic and BigTIFF) and .npy bodies; convert other "
        "containers (e.g. with gdal_translate) first. Decoding this one "
        f"is ROADMAP queue 1 item {item}.")


def decode_image_bytes(data: bytes) -> GeoTIFF:
    """Decode a TIFF/GeoTIFF from bytes, with its georeferencing;
    bands-last. Other containers raise UnsupportedFormatError."""
    if _is_tiff(data):
        return _named("GeoTIFF", decode_geotiff, data)
    raise _unsupported(data)


def sniff_image_info(data: bytes) -> RasterInfo:
    """Shape, dtype and georeferencing of a TIFF/GeoTIFF from its header,
    without decoding pixels. Other containers raise
    UnsupportedFormatError."""
    if _is_tiff(data):
        return _named("GeoTIFF", decode_geotiff_info, data)
    raise _unsupported(data)
