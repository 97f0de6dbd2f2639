"""Image codecs and the decode-from-bytes dispatch.

A copy of the JAX package's ``raster/image.py``. The port decodes
TIFF/GeoTIFF (classic and BigTIFF) with its own reader
(``raster/geotiff.py``), JPEG 2000 (JP2 and raw J2K, with GeoJP2/GMLJP2
georeferencing) with ``raster/jp2.py``, PNG, JPEG, GIF (first frame) and
BMP with its own codecs (``raster/png.py``, ``jpeg.py``, ``gif.py``,
``bmp.py``), where the JAX package uses PIL, and the scientific
containers with copies of the JAX package's decoders: NetCDF classic
(``netcdf.py``), GRIB 1 and 2 (``grib.py``), GDAL VRT (``vrt.py``), ENVI
(``envi.py``), HDF4 (``hdf4.py``), NITF (``nitf.py``) and GeoPackage
rasters (``gpkg_raster.py``), and HDF5 / NetCDF-4 with its own reader
(``hdf5.py``), where the JAX package uses h5py. Decoded arrays equal the
JAX package's, PIL's mode mapping included; the JPEG encoder's bytes
equal PIL's. ``decode_image_bytes`` sniffs the container from its magic
bytes, in the JAX package's order. JPEG covers what PIL opens
(progressive, arithmetic-coded, lossless, CMYK/YCCK, see ``jpeg.py``),
BMP its RLE8/RLE4 files, JPEG 2000 its subsampled and sYCC files; what
PIL refuses raises :class:`CorruptRasterError`, as in the JAX package.
A progressive JPEG that libjpeg-turbo block-smooths and HTJ2K raise
:class:`UnsupportedFormatError` naming ROADMAP queue 1 item 6; the parts
of HDF5 the reader refuses (external storage, virtual datasets, external
links, SOHM) name item 14.

``decode_png``, ``decode_jpeg`` and ``png_to_jpeg`` open the bytes as the
JAX package's do, through PIL: ``pil_open.py`` walks PIL's openers and
raises PIL's exception classes, and decodes TIFF as PIL reads it, WebP,
PPM, TGA, SGI, PCX, QOI, ICO/CUR, IM, XBM, GBR and DDS besides the
formats above; what PIL opens and the port does not decode names ROADMAP
queue 1 item 16. ``decode_image_bytes`` keeps its dispatch.

``sniff_image_info`` reads shape and dtype from headers without decoding
pixels. For JPEG, PNG, GIF and BMP it reports what the port's decoder
returns, or raises what it raises from the headers (a JPEG of another
precision than 8 bits, of 2 components, hierarchical or arithmetic
lossless: the JAX sniffer reports these), where the JAX
package's sniffer does not in places (16-bit RGB(A) PNG: uint8, not
uint16; 16-bit grey+alpha PNG: 4 bands, not 2; 1-bit grey PNG and
black/white BMP: bool; BMP palettes that are grey but not the identity
ramp: 3 bands; 32-bit BMP without an alpha mask: 3 bands), and so for a
GeoPackage's PNG tiles; for NITF and GeoPackage it reports what their
decoders return, or raises what they raise (a C8 NITF georeferenced
inside its codestream, images the decoders refuse).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .bmp import bmp_layout, decode_bmp_array
from .envi import decode_envi, is_envi_header, sniff_envi_info
from .geotiff import GeoTIFF, RasterInfo, decode_geotiff, decode_geotiff_info
from .gif import decode_gif_array, gif_layout
from .gpkg_raster import decode_gpkg, is_gpkg, sniff_gpkg_info
from .grib import decode_grib, is_grib, sniff_grib_info
from .hdf4 import decode_hdf4, is_hdf4, sniff_hdf4_info
from .hdf5 import HDF5Unsupported, decode_hdf5, is_hdf5, sniff_hdf5_info
from .jp2 import (JP2Unsupported, decode_jp2, is_jp2, palette_rgb,
                  sniff_jp2_info)
from .jpeg import (JPEGUnsupported, decode_jpeg_array, encode_jpeg_array,
                   jpeg_header)
from .netcdf import decode_netcdf, is_netcdf_classic, sniff_netcdf_info
from .nitf import decode_nitf, is_nitf, sniff_nitf_info
from .pil_open import (DecompressionBombError, UnidentifiedImageError,
                       UnsupportedFormat, pil_decode)
from .png import decode_png_array, decoded_layout, encode_png_array, png_header
from .vrt import decode_vrt, is_vrt, sniff_vrt_info

__all__ = ["CorruptRasterError", "DecompressionBombError",
           "UnidentifiedImageError", "UnsupportedFormatError", "decode_image",
           "decode_image_bytes", "decode_jpeg", "decode_png", "encode_jpeg",
           "encode_png", "png_to_jpeg", "sniff_image_info"]


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
    except (JPEGUnsupported, JP2Unsupported,
            HDF5Unsupported) as e:
        raise UnsupportedFormatError(str(e)) from e
    except Exception as e:
        raise CorruptRasterError(
            f"corrupt or unreadable {fmt} container; "
            f"{type(e).__name__}: {e}") from e


def _is_png(data: bytes) -> bool:
    return data[:8] == b"\x89PNG\r\n\x1a\n"


def _is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


def _is_tiff(data: bytes) -> bool:
    # classic TIFF (version 42) or BigTIFF (version 43)
    return data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")


def _is_bmp(data: bytes) -> bool:
    return data[:2] == b"BM"


def _is_gif(data: bytes) -> bool:
    return data[:4] == b"GIF8"


def _unsupported(data: bytes) -> UnsupportedFormatError:
    return UnsupportedFormatError(
        f"unsupported raster format: unknown container (magic bytes "
        f"{data[:4]!r}). Supported formats: "
        "GeoTIFF, PNG, JPEG, JPEG 2000, BMP, NetCDF, HDF4, HDF5, "
        "GRIB (1+2), ENVI, VRT (GIF decode-only); convert other "
        "containers (e.g. with gdal_translate) before ingestion.")


def _container(data: bytes):
    """(format name, decoder, sniffer) of a scientific container, in the
    JAX package's order, or None."""
    if is_netcdf_classic(data):
        return "NetCDF", decode_netcdf, sniff_netcdf_info
    if is_hdf5(data):
        # covers NetCDF-4 too (an HDF5 container with CF attributes)
        return "HDF5", decode_hdf5, sniff_hdf5_info
    if is_grib(data):
        return "GRIB", decode_grib, sniff_grib_info
    if is_vrt(data):
        return "VRT", decode_vrt, sniff_vrt_info
    if is_envi_header(data):
        return "ENVI", decode_envi, sniff_envi_info
    if is_hdf4(data):
        return "HDF4", decode_hdf4, sniff_hdf4_info
    if is_nitf(data):
        return "NITF", decode_nitf, sniff_nitf_info
    if is_gpkg(data):
        return "GeoPackage", decode_gpkg, sniff_gpkg_info
    return None


def _three_d(arr: np.ndarray, what: str) -> np.ndarray:
    # the JAX package asserts a 3-D result of at most 3 bands here, so a
    # CMYK JPEG or an RGBA PNG fails with its AssertionError
    if arr.ndim != 3 or arr.shape[2] > 3:
        raise AssertionError(f"{what} decoded to shape {arr.shape}: the "
                             "chip codecs take at most 3 bands")
    return arr


def _decode_any(data: bytes, what: str) -> np.ndarray:
    # the JAX package's decode_png and decode_jpeg open the bytes with
    # PIL, which takes any image container it knows, whatever the name,
    # and lets its own exceptions out
    try:
        arr = pil_decode(data)
    except UnsupportedFormat as e:
        raise UnsupportedFormatError(str(e)) from e
    return _three_d(arr, what)


def decode_png(data: bytes) -> np.ndarray:
    """Image bytes of any format PIL opens -> (H, W, B), at most 3 bands;
    PIL's exceptions where it fails (``pil_open.py``)."""
    return _decode_any(data, "PNG")


def decode_jpeg(data: bytes) -> np.ndarray:
    """Image bytes of any format PIL opens -> (H, W, B), at most 3 bands;
    PIL's exceptions where it fails (``pil_open.py``)."""
    return _decode_any(data, "JPEG")


def encode_png(array: np.ndarray) -> bytes:
    """uint8 with 1-3 bands, or uint16 with 1 band -> PNG bytes."""
    return encode_png_array(array)


def encode_jpeg(array: np.ndarray, quality: int = 100) -> bytes:
    """uint8 with 1 or 3 bands -> the JPEG bytes PIL writes at this
    quality."""
    return encode_jpeg_array(array, quality)


# the PIL mode Image.fromarray gives an array, for the ones PIL's JPEG
# writer refuses
_FROMARRAY_MODES = {("<u2", 1): "I;16", (">u2", 1): "I;16B", ("<i4", 1): "I",
                    ("<f4", 1): "F", ("|u1", 2): "LA", ("|u1", 4): "RGBA"}


def png_to_jpeg(data: bytes, quality: int = 100) -> bytes:
    """Image bytes -> JPEG, as the JAX package transcodes them (PIL's
    ``Image.fromarray(decode_png(data)).save(..., "JPEG")``): a bilevel
    image is written as grey 0/255, the modes PIL's JPEG writer refuses
    raise its ``OSError``."""
    arr = decode_png(data)
    if arr.dtype == bool:
        arr = arr.view(np.uint8)
    mode = _FROMARRAY_MODES.get((arr.dtype.str, arr.shape[2]))
    if mode is not None:
        raise OSError(f"cannot write mode {mode} as JPEG")
    return encode_jpeg(arr, quality=quality)


def _jp2_array(data: bytes) -> np.ndarray:
    # the JAX package's decode_png/decode_jpeg take a palette JP2 (PIL
    # mode P) through convert("RGB"); decode_jp2 gives its indices
    arr = decode_jp2(data).array
    table = palette_rgb(data)
    return arr if table is None else table[arr[:, :, 0]]


def _decode_pixels(data: bytes):
    """(format name, decoder) of a PNG, JPEG, GIF, BMP or JPEG 2000
    file (PIL opens each of them); None otherwise."""
    if is_jp2(data):
        return "JPEG 2000", _jp2_array
    if _is_png(data):
        return "PNG", decode_png_array
    if _is_jpeg(data):
        return "image", decode_jpeg_array
    if _is_gif(data):
        return "image", decode_gif_array
    if _is_bmp(data):
        return "image", decode_bmp_array
    return None


def decode_image_bytes(data: bytes, base_dir: Optional[str] = None,
                       origin: Optional[str] = None,
                       allow_sources: bool = True) -> GeoTIFF:
    """Decode a supported raster from bytes, with its georeferencing when
    the container carries it; bands-last. ``base_dir`` (the directory of
    the file) and ``origin`` (its file name) serve the multi-file
    containers: a VRT's ``relativeToVRT`` sources and the ENVI data file
    next to its header. Other containers raise UnsupportedFormatError.

    A VRT reads the paths and URLs that its XML names. Bytes from an
    untrusted sender (a request body) are decoded with
    ``allow_sources=False``, which refuses a VRT before anything is read,
    so the sender cannot choose files or URLs to fetch. The parts of an
    HDF5 file that name other files (external storage, virtual datasets,
    external links) are refused unread in every context."""
    if _is_tiff(data):
        return _named("GeoTIFF", decode_geotiff, data)
    if is_jp2(data):
        # Sentinel-2's format: the port's JPEG 2000 codec, with the
        # GeoJP2/GMLJP2 georeferencing
        return _named("JPEG 2000", decode_jp2, data)
    codec = _decode_pixels(data)
    if codec is not None:
        arr = _named(codec[0], codec[1], data)
        info = RasterInfo(width=arr.shape[1], height=arr.shape[0],
                          count=arr.shape[2], dtype=arr.dtype.name)
        return GeoTIFF(arr, info)
    found = _container(data)
    if found is None:
        raise _unsupported(data)
    name, decode, _ = found
    if name == "VRT":
        if not allow_sources:
            raise UnsupportedFormatError(
                "VRT refused: a VRT reads the files and URLs it names, "
                "and this input may not choose them")
        return _named(name, decode, data, base_dir=base_dir)
    if name == "ENVI":
        return _named(name, decode, data, base_dir=base_dir, origin=origin)
    return _named(name, decode, data)


def decode_image(data: bytes) -> np.ndarray:
    """bytes -> (H, W, B) array (tf.io.decode_image's role)."""
    return decode_image_bytes(data).array


def _sniff_png(data: bytes) -> RasterInfo:
    w, h, depth, ct, _ = png_header(data)
    bands, dtype = decoded_layout(depth, ct)
    return RasterInfo(width=w, height=h, count=bands, dtype=dtype)


def _sniff_jpeg(data: bytes) -> RasterInfo:
    # the decoder's own marker reader, up to the first scan
    h, w, c = jpeg_header(data)
    return RasterInfo(width=w, height=h, count=c, dtype="uint8")


def _sniff_gif(data: bytes) -> RasterInfo:
    w, h, bands = gif_layout(data)
    return RasterInfo(width=w, height=h, count=bands, dtype="uint8")


def _sniff_bmp(data: bytes) -> RasterInfo:
    w, h, bands, dtype = bmp_layout(data)
    return RasterInfo(width=w, height=h, count=bands, dtype=dtype)


def sniff_image_info(data: bytes) -> RasterInfo:
    """Shape and dtype (and a GeoTIFF's georeferencing) from headers,
    without decoding pixels. Other containers raise
    UnsupportedFormatError."""
    if _is_png(data):
        return _named("PNG", _sniff_png, data)
    if _is_jpeg(data):
        return _named("JPEG", _sniff_jpeg, data)
    if _is_tiff(data):
        return _named("GeoTIFF", decode_geotiff_info, data)
    if is_jp2(data):
        return _named("JPEG 2000", sniff_jp2_info, data)
    if _is_bmp(data):
        return _named("BMP", _sniff_bmp, data)
    if _is_gif(data):
        return _named("GIF", _sniff_gif, data)
    found = _container(data)
    if found is None:
        raise _unsupported(data)
    return _named(found[0], found[2], data)
