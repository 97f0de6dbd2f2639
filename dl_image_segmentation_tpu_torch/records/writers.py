"""GeoTIFF chip folders -> sharded TFRecords (the MP engine).

A copy of the JAX package's ``records/writers.py``, trimmed to
``process_dataset_mp`` over local GeoTIFF chip folders; its shards are
byte for byte the JAX package's. Contracts kept:

* shard files named '%s-%.5d-of-%.5d';
* images and labels paired by file name, then shuffled with
  ``random.seed(12345)``'s sequence;
* num_shards % num_workers == 0, each worker writing a contiguous range
  of shards;
* identifier = the file name with '#' -> ':' (the DLTile key), or
  '{filename}|{geotransform}|{crs}';
* a pair that fails to load is skipped with a message;
* ``resume`` skips shards that exist (the writer renames a shard into
  place only once it is complete).

``store_as_array=True`` stores decoded arrays (FloatList, the tifarr
mode, or BytesList for uint8 pairs: rgbarr), ``False`` the GeoTIFF bytes
(tifraw). The MT engine (PNG/JPEG pairs) raises: it needs PIL.
"""

from __future__ import annotations

import os
import random
import sys
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..raster.image import (CorruptRasterError, UnsupportedFormatError,
                            decode_image_bytes, sniff_image_info)
from .example import write_example_framed
from .parsers import RGBRAW_NOT_PORTED
from .tfrecord import TFRecordWriter, check_local, shard_filename

__all__ = ["process_dataset_mp", "process_dataset_multithreaded"]


def _tile_key_from_filename(path: str) -> str:
    base = os.path.basename(path)
    stem = ".".join(base.split(os.extsep)[:-1])
    return stem.replace("#", ":")


def _find_image_files(data_dir: str, file_ext: Sequence[str]
                      ) -> Tuple[List[str], List[str]]:
    """Image and label files paired by name, in the seed-12345 shuffled
    order."""
    img_dir = os.path.join(check_local(data_dir), "images")
    lbl_dir = os.path.join(data_dir, "labels")
    suffixes = tuple(f".{e}" for e in file_ext)
    try:
        img_names = sorted(e.name for e in os.scandir(img_dir)
                           if not e.name.startswith(".")
                           and e.name.endswith(suffixes))
    except FileNotFoundError:
        img_names = []
    try:
        lbl_names = {e.name for e in os.scandir(lbl_dir)}
    except FileNotFoundError:
        lbl_names = set()
    missing = [n for n in img_names if n not in lbl_names]
    if missing:
        raise FileNotFoundError(
            f"{len(missing)} images have no matching label file, e.g. "
            f"{os.path.join(img_dir, missing[0])!r} (images and labels "
            "must be identically named)")
    order = list(range(len(img_names)))
    random.Random(12345).shuffle(order)  # random.seed(12345)'s sequence
    filenames = [os.path.join(img_dir, img_names[i]) for i in order]
    labels = [os.path.join(lbl_dir, img_names[i]) for i in order]
    print(f"Found {len(filenames)} image files and {len(labels)} label "
          f"files inside {data_dir}.")
    return filenames, labels


def _load_any(path: str, dltile_from_filename: bool, decode: bool):
    """(array or file bytes, h, w, bands, identifier) of one GeoTIFF;
    without ``decode`` only the header is read."""
    with open(path, "rb") as f:
        data = f.read()
    if decode:
        g = decode_image_bytes(data)
        info = g.info
    else:
        info = sniff_image_info(data)
    h, w, bands = info.height, info.width, info.count
    if dltile_from_filename:
        key = _tile_key_from_filename(path)
    elif info.geotransform is not None and info.crs is not None:
        key = "|".join((os.path.basename(path), str(list(info.geotransform)),
                        info.crs))
    else:
        key = os.path.basename(path)
    if decode:
        if g.array.shape != (h, w, bands):
            raise ValueError(f"{path}: decoded {g.array.shape}, header "
                             f"says {(h, w, bands)}")
        return g.array, h, w, bands, key
    return data, h, w, bands, key


def _skip_reason(e: Exception) -> str:
    if isinstance(e, UnsupportedFormatError):
        return str(e).split(".")[0]
    if isinstance(e, CorruptRasterError):
        return str(e).split(";")[0]
    return type(e).__name__


def _write_one_shard(writer, worker_index: int, img_files, lbl_files,
                     indices, dltile_from_filename: bool,
                     store_as_array: bool, progress_every: int,
                     counter: int, files_in_worker: int
                     ) -> Tuple[int, dict]:
    """Write one shard's records; (count written, {skip reason: count})."""
    written = 0
    skipped: dict = {}
    for i in indices:
        filename = img_files[i]
        try:
            img_buf, ih, iw, ib, ikey = _load_any(
                filename, dltile_from_filename, store_as_array)
            lbl_buf, lh, lw, _, lkey = _load_any(
                lbl_files[i], dltile_from_filename, store_as_array)
            if ikey != lkey:
                raise ValueError(f"identifiers differ: {ikey!r}, {lkey!r}")
        except Exception as e:  # noqa: BLE001 -- skip-and-continue contract
            print(e)
            print(f"SKIPPED: Unexpected error while decoding {filename}.")
            reason = _skip_reason(e)
            skipped[reason] = skipped.get(reason, 0) + 1
            continue
        # labels are single-band: store (h, w)
        if store_as_array and lbl_buf.ndim == 3 and lbl_buf.shape[2] == 1:
            lbl_buf = lbl_buf[:, :, 0]
        write_example_framed(writer.fileobj, img_buf, lbl_buf, ih, iw, ib,
                             lh, lw, ikey)
        written += 1
        counter += 1
        if progress_every and not counter % progress_every:
            print(f"{datetime.now()} [worker {worker_index}]: Processed "
                  f"{counter} of {files_in_worker} images in batch.")
            sys.stdout.flush()
    return written, skipped


def _worker(worker_index: int, ranges, name: str, img_files, lbl_files,
            out_dir: str, num_shards: int, dltile_from_filename: bool,
            store_as_array: bool, progress_every: int, resume: bool
            ) -> Tuple[int, dict]:
    """Write this worker's contiguous range of shards; (examples written,
    {skip reason: count})."""
    shards_per_worker = num_shards // len(ranges)
    lo, hi = ranges[worker_index]
    shard_ranges = np.linspace(lo, hi, shards_per_worker + 1).astype(int)
    counter = 0
    skipped: dict = {}
    for s in range(shards_per_worker):
        shard = worker_index * shards_per_worker + s
        output_file = os.path.join(out_dir,
                                   shard_filename(name, shard, num_shards))
        if resume and os.path.exists(output_file):
            print(f"{datetime.now()} [worker {worker_index}]: shard "
                  f"{output_file} exists, skipping (resume)")
            continue
        writer = TFRecordWriter(output_file)
        try:
            n, shard_skips = _write_one_shard(
                writer, worker_index, img_files, lbl_files,
                range(shard_ranges[s], shard_ranges[s + 1]),
                dltile_from_filename, store_as_array, progress_every,
                counter, hi - lo)
        except BaseException:
            writer.abort()  # the .tmp is never renamed into place
            raise
        writer.close()
        counter += n
        for k, v in shard_skips.items():
            skipped[k] = skipped.get(k, 0) + v
        print(f"{datetime.now()} [worker {worker_index}]: Wrote {n} images "
              f"to {output_file}")
        sys.stdout.flush()
    return counter, skipped


def process_dataset_mp(name: str, directory: str, out_directory: str,
                       num_shards: int, num_proc: Optional[int] = None,
                       dltile_from_filename: bool = True,
                       file_ext: str = "tif",
                       store_as_array: bool = True,
                       resume: bool = False) -> int:
    """GeoTIFF chip folder (``images/`` and ``labels/``) -> ``num_shards``
    TFRecord shards in ``out_directory``, written by ``num_proc`` worker
    threads (default one a shard). Returns the examples written."""
    num_workers = num_proc or num_shards
    if num_shards % num_workers:
        raise ValueError("Num shards must be a multiple of num workers "
                         "(incl 1*)")
    img_files, lbl_files = _find_image_files(directory, [file_ext])
    os.makedirs(check_local(out_directory), exist_ok=True)
    spacing = np.linspace(0, len(img_files), num_workers + 1).astype(int)
    ranges = [[spacing[i], spacing[i + 1]] for i in range(num_workers)]
    print(f"Launching {num_workers} workers for spacings: {ranges}")
    sys.stdout.flush()
    args = (ranges, name, img_files, lbl_files, out_directory, num_shards,
            dltile_from_filename, store_as_array, 100, resume)
    # the worker count fixes which records go to which shard; the pool is
    # capped at the host's cores
    with ThreadPoolExecutor(min(num_workers, os.cpu_count() or 1)) as ex:
        results = list(ex.map(lambda w: _worker(w, *args),
                              range(num_workers)))
    skipped: dict = {}
    for _, sk in results:
        for k, v in sk.items():
            skipped[k] = skipped.get(k, 0) + v
    print(f"{datetime.now()}: Finished writing all {len(img_files)} images "
          "in data set.")
    for reason, n in sorted(skipped.items()):
        print(f"WARNING: {n} file(s) skipped: {reason}")
    sys.stdout.flush()
    return sum(r[0] for r in results)


def process_dataset_multithreaded(*args, **kwargs) -> int:
    """PNG/JPEG chip pairs: not ported (see RGBRAW_NOT_PORTED)."""
    raise NotImplementedError(RGBRAW_NOT_PORTED)
