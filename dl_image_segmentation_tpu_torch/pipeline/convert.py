"""Chip-folder conversion: GeoTIFF pairs -> PNG/JPG pairs for the MT
engine.

A copy of the JAX package's ``pipeline/convert.py`` through the port's
storage layer and codecs (``raster/png.py``, ``raster/jpeg.py``): the
same file names, pixels (PNG) and bytes (JPG). Decoding and encoding
release the GIL, so the fan-out is a thread pool. Existing outputs are
skipped (resumable); ``rescale=(lo, hi)`` maps imagery into uint8 on
the way; labels pass through unless ``rescale_labels``; georeferencing
is not written beside the PNG (the DLTile-key file name carries it).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

from ..raster.image import UnsupportedFormatError, encode_jpeg, encode_png

_SUBFOLDERS = ("images", "labels")


def _to_uint8(arr: np.ndarray, rescale: Tuple[float, float]) -> np.ndarray:
    lo, hi = float(rescale[0]), float(rescale[1])
    if hi <= lo:
        raise ValueError(f"rescale needs lo < hi, got ({lo}, {hi})")
    scaled = (arr.astype(np.float32) - lo) * (255.0 / (hi - lo))
    return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)


def _convert_one(src_path: str, dst_path: str, to: str, quality: int,
                 rescale: Optional[Tuple[float, float]]) -> bool:
    """Convert one raster file; returns False if the output already
    existed (resume skip). Raises on anything the target can't hold."""
    from .. import storage
    if storage.exists(dst_path):
        return False
    from ..raster.image import decode_image_bytes
    g = decode_image_bytes(storage.read_bytes(src_path),
                           base_dir=storage.dirname(src_path),
                           origin=storage.basename(src_path))
    arr = g.array
    if rescale is not None:
        arr = _to_uint8(arr, rescale)
    bands = arr.shape[2]
    if to == "jpg":
        if arr.dtype != np.uint8 or bands not in (1, 3):
            raise UnsupportedFormatError(
                f"JPEG holds uint8 1/3-band only; {src_path!r} is "
                f"{arr.dtype.name} {bands}-band (use --rescale for "
                "higher dtypes, or keep GeoTIFF and use the "
                "any-format engine / store_as_array=True)")
        data = encode_jpeg(arr, quality=quality)
    else:
        # PNG: uint8 1-3 bands (the MT engine's <=3-band contract) or
        # uint16 single band
        if not (arr.dtype == np.uint8 and bands <= 3) and \
                not (arr.dtype == np.uint16 and bands == 1):
            raise UnsupportedFormatError(
                f"PNG chips hold uint8 <=3-band or uint16 1-band; "
                f"{src_path!r} is {arr.dtype.name} {bands}-band (use "
                "--rescale lo hi to map into uint8, or keep GeoTIFF "
                "and use the any-format engine / store_as_array=True)")
        data = encode_png(arr)
    storage.write_bytes(dst_path, data)  # atomic both backends
    return True


def convert_chip_folder(directory: str, out_directory: str,
                        file_ext: str = "tif", to: str = "png",
                        num_workers: int = 8, quality: int = 100,
                        rescale: Optional[Sequence[float]] = None,
                        rescale_labels: bool = False) -> int:
    """Convert a chip folder's parallel ``images/`` + ``labels/`` trees
    to PNG (or JPG) pairs the MT translation engine can read, preserving
    the DLTile-key filenames.

    ``rescale=(lo, hi)`` linearly maps imagery into uint8; labels are
    class ids and pass through untouched unless ``rescale_labels=True``.
    Existing outputs are skipped (resumable). Returns files written.
    """
    if to not in ("png", "jpg"):
        raise ValueError(f"to must be 'png' or 'jpg', got {to!r}")
    from .. import storage
    rs = tuple(float(v) for v in rescale) if rescale is not None else None
    jobs = []
    for sub in _SUBFOLDERS:
        src_dir = storage.join(directory, sub)
        dst_dir = storage.join(out_directory, sub)
        names = sorted(
            n for n in storage.listdir(src_dir)
            if not n.startswith(".") and n.endswith(f".{file_ext}"))
        if not names:
            raise FileNotFoundError(
                f"no .{file_ext} files in {src_dir!r}")
        storage.makedirs(dst_dir, exist_ok=True)
        sub_rs = rs if (sub == "images" or rescale_labels) else None
        for name in names:
            stem = name[:-(len(file_ext) + 1)]
            jobs.append((storage.join(src_dir, name),
                         storage.join(dst_dir, f"{stem}.{to}"), sub_rs))
    written = 0
    width = max(1, min(num_workers, len(jobs)))
    with ThreadPoolExecutor(max_workers=width) as ex:
        futs = [ex.submit(_convert_one, s, d, to, quality, r)
                for s, d, r in jobs]
        for f in futs:
            written += bool(f.result())
    print(f"Converted {written} of {len(jobs)} files from {directory} "
          f"to {out_directory} ({len(jobs) - written} already present).")
    return written
