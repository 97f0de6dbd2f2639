"""Stitch per-tile chips back into a seamless georeferenced mosaic.

The inverse of the tiling step: tile rasters carry ``pad`` pixels of
overlap on every side (README.md:13-15 of the reference); stitching
strips the padding and pastes each tile's unpadded core into a single
raster on the common grid. Used to assemble model predictions (from
``dlseg-tpu predict``) into one map, completing the
chips -> train -> predict -> mosaic loop the reference only sketches
(its stack_products_for_tile consumes such mosaics from the remote
catalog, _descartes_img_chips.py:472-518).

All tiles must share zone + resolution + tile size (one grid). Output
is written with the port's GeoTIFF codec, LZW tiled, georeferenced.
Folders and outputs are local paths; object storage comes with the
storage slice of the port.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..geo.tilegrid import Tile
from ..raster.geotiff import (decode_geotiff_info, read_geotiff,
                              write_geotiff)


def _grid_frame(tiles):
    """Shared mosaic-frame math: validates the one-grid invariant and
    returns (t0, ti_min, tj_max, width, height, geotransform, epsg)."""
    t0 = tiles[0]
    for t in tiles:
        if (t.zone != t0.zone or t.resolution != t0.resolution
                or t.tilesize != t0.tilesize or t.pad != t0.pad):
            raise ValueError(
                f"tile {t.key} is not on the same grid as {t0.key}")
    ti_min = min(t.ti for t in tiles)
    ti_max = max(t.ti for t in tiles)
    tj_min = min(t.tj for t in tiles)
    tj_max = max(t.tj for t in tiles)  # the frame hangs from the north
    ts = t0.tilesize
    width = (ti_max - ti_min + 1) * ts
    height = (tj_max - tj_min + 1) * ts
    # geotransform of the mosaic (top-left of the northwest tile core);
    # hemisphere-aware CRS: EPSG:327xx + false northing when every tile
    # is south of the equator, EPSG:326xx otherwise (an equator-
    # straddling mosaic keeps the northern CRS with negative southern
    # northings -- consistent, if unconventional)
    south = all(t.tj < 0 for t in tiles)
    epsg = (32700 if south else 32600) + t0.zone
    fn = 10_000_000.0 if south else 0.0
    x0 = t0.bounds_unpadded[0] + (ti_min - t0.ti) * t0.span_m
    y1 = t0.bounds_unpadded[3] + (tj_max - t0.tj) * t0.span_m + fn
    gt = (x0, t0.resolution, 0.0, y1, 0.0, -t0.resolution)
    return t0, ti_min, tj_max, width, height, gt, epsg


def _paste(mosaic: np.ndarray, tile: Tile, arr: np.ndarray,
           ti_min: int, tj_max: int) -> None:
    ts, pad = tile.tilesize, tile.pad
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    core = arr[pad:pad + ts, pad:pad + ts, :]
    # row 0 of the mosaic is the NORTHERNMOST row: tj_max at top
    row0 = (tj_max - tile.tj) * ts
    col0 = (tile.ti - ti_min) * ts
    mosaic[row0:row0 + ts, col0:col0 + ts, :] = core


def stitch_tiles(
    chips: Dict[Tile, np.ndarray],
    fill_value: float = 0,
    dtype=None,
) -> Tuple[np.ndarray, Tuple[float, ...], int]:
    """Merge {tile: padded array (H, W[, B])} into one mosaic.

    Returns (mosaic, geotransform, epsg)."""
    if not chips:
        raise ValueError("no chips to stitch")
    tiles = list(chips)
    t0, ti_min, tj_max, width, height, gt, epsg = _grid_frame(tiles)
    sample = np.asarray(chips[t0])
    bands = 1 if sample.ndim == 2 else sample.shape[2]
    out_dtype = dtype or sample.dtype
    mosaic = np.full((height, width, bands), fill_value, dtype=out_dtype)
    for t, arr in chips.items():
        _paste(mosaic, t, arr, ti_min, tj_max)
    return mosaic.squeeze(-1) if bands == 1 else mosaic, gt, epsg


def stitch_folder(chip_dir: str, out_path: str,
                  fill_value: float = 0) -> Tuple[int, Tuple[int, int]]:
    """Stitch every chip in a folder (tile-key filenames) into one
    GeoTIFF; non-tile-key .tif files (e.g. a previous run's mosaic in
    the same folder) are skipped. Chips are read and pasted one at a
    time -- peak memory is one mosaic plus one chip, not two mosaics.
    Returns (n_tiles, (height, width))."""
    if "://" in chip_dir:
        raise NotImplementedError(
            f"cannot list {chip_dir!r}: object storage (gs://, s3://, "
            "https://) comes with the storage slice of the port")
    files = sorted(glob.glob(os.path.join(chip_dir, "*.tif")))
    entries = []
    for f in files:
        try:
            entries.append((Tile.from_filename(os.path.basename(f)), f))
        except ValueError:
            continue  # stray non-chip .tif, e.g. an earlier mosaic
    if not entries:
        raise FileNotFoundError(f"no tile-key .tif chips in {chip_dir}")
    tiles = [t for t, _ in entries]
    t0, ti_min, tj_max, width, height, gt, epsg = _grid_frame(tiles)
    with open(entries[0][1], "rb") as f:
        info0 = decode_geotiff_info(f.read())
    nodata: Optional[float] = info0.nodata
    mosaic = np.full((height, width, info0.count),
                     fill_value, dtype=np.dtype(info0.dtype))
    for tile, f in entries:
        _paste(mosaic, tile, read_geotiff(f).array, ti_min, tj_max)
    if info0.count == 1:
        mosaic = mosaic.squeeze(-1)
    # large mosaics exceed classic TIFF's 4 GiB offset space; "auto"
    # decides from the actual compressed sizes (LZW can EXPAND noisy
    # data, so a raw-nbytes heuristic here could still overflow)
    write_geotiff(out_path, mosaic, geotransform=gt, epsg=epsg,
                  nodata=nodata, bigtiff="auto")
    return len(entries), mosaic.shape[:2]
