"""Chip folders -> sharded TFRecords: the MP and MT engines.

A copy of the JAX package's ``records/writers.py``:
``process_dataset_mp`` over chip folders of any raster container the
port decodes (GeoTIFF, JPEG 2000, ENVI headers, NetCDF, ...) and
``process_dataset_multithreaded`` (the MT engine) over PNG/JPEG chip
folders, also under the facade's names ``images_to_tfrecords_mp`` and
``images_to_tfrecords_mt``; their shards are byte for byte the JAX
package's (whichever of its paths, C++ or Python, wrote them). Chip folders may be local, gs://,
s3:// or http(s)://, and the output directory local, gs:// or s3://,
through the storage layer. Contracts kept:

* shard files named '%s-%.5d-of-%.5d';
* images and labels paired by file name, then shuffled with
  ``random.seed(12345)``'s sequence;
* num_shards % num_workers == 0, each worker writing a contiguous range
  of shards;
* identifier = the file name with '#' -> ':' (the DLTile key), or
  '{filename}|{geotransform}|{crs}';
* a pair that fails to load is skipped with a message;
* ``resume`` skips shards that exist (the writer renames or uploads a
  shard into place only once it is complete);
* ``host_index`` / ``host_count`` split one run over hosts (or ranks):
  each takes a contiguous slice of the shuffled file list and the
  matching range of shards, numbered globally, so the hosts' shards
  together are the one-host run's.

``store_as_array=True`` stores decoded arrays (FloatList, the tifarr
mode, or BytesList for uint8 pairs: rgbarr), ``False`` the file bytes
(tifraw for GeoTIFF, rgbraw for PNG/JPEG). The MT engine keeps the JAX
package's quirks: a file is PNG when ``.png`` is anywhere in its path,
and ``convert_png_to_jpg`` transcodes every PNG, labels included, to a
quality-100 JPEG (the port's encoder, byte for byte PIL's).
"""

from __future__ import annotations

import functools
import os
import random
import sys
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .. import storage
from ..raster.image import (CorruptRasterError, UnsupportedFormatError,
                            decode_image_bytes, decode_jpeg, decode_png,
                            png_to_jpeg, sniff_image_info)
from .example import write_example_framed
from .tfrecord import TFRecordWriter, shard_filename

__all__ = ["images_to_tfrecords_mp", "images_to_tfrecords_mt",
           "process_dataset_mp", "process_dataset_multithreaded"]


def _tile_key_from_filename(path: str) -> str:
    base = storage.basename(path)
    stem = ".".join(base.split(os.extsep)[:-1])
    return stem.replace("#", ":")


def _find_image_files(data_dir: str, file_ext: Sequence[str]
                      ) -> Tuple[List[str], List[str]]:
    """Image and label files paired by name, in the seed-12345 shuffled
    order. A remote folder is listed with one prefix list per folder."""
    img_dir = storage.join(data_dir, "images")
    lbl_dir = storage.join(data_dir, "labels")
    suffixes = tuple(f".{e}" for e in file_ext)
    if storage.is_remote(data_dir):
        def names(d):
            return storage.listdir(d)
    else:
        def names(d):
            return [e.name for e in os.scandir(d)]
    try:
        img_names = sorted(n for n in names(img_dir)
                           if not n.startswith(".") and n.endswith(suffixes))
    except FileNotFoundError:
        img_names = []
    try:
        lbl_names = set(names(lbl_dir))
    except FileNotFoundError:
        lbl_names = set()
    missing = [n for n in img_names if n not in lbl_names]
    if missing:
        raise FileNotFoundError(
            f"{len(missing)} images have no matching label file, e.g. "
            f"{storage.join(img_dir, missing[0])!r} (images and labels "
            "must be identically named)")
    order = list(range(len(img_names)))
    random.Random(12345).shuffle(order)  # random.seed(12345)'s sequence
    filenames = [storage.join(img_dir, img_names[i]) for i in order]
    labels = [storage.join(lbl_dir, img_names[i]) for i in order]
    print(f"Found {len(filenames)} image files and {len(labels)} label "
          f"files inside {data_dir}.")
    return filenames, labels


def _load_mt(path: str, dltile_from_filename: bool, png_to_jpg: bool,
             decode: bool):
    """(array or file bytes, h, w, bands, identifier) of one PNG or JPEG
    chip of at most 3 bands; without ``decode`` only the header is
    read."""
    data = storage.read_bytes(path)
    is_png = ".png" in path  # a substring test, as in the JAX package
    if is_png and png_to_jpg and not decode:
        data = png_to_jpeg(data)
        is_png = False
    if decode:
        image = decode_png(data) if is_png else decode_jpeg(data)
        h, w, bands = image.shape
    else:
        info = sniff_image_info(data)
        h, w, bands = info.height, info.width, info.count
        if bands > 3:
            # the JAX package asserts here
            raise AssertionError(f"{path}: {bands} bands; the MT engine "
                                 "takes at most 3")
    key = (_tile_key_from_filename(path) if dltile_from_filename
           else storage.basename(path))
    return (image if decode else data), h, w, bands, key


def _load_any(path: str, dltile_from_filename: bool, decode: bool):
    """(array or file bytes, h, w, bands, identifier) of one raster of
    any container the port decodes; without ``decode`` only the header
    is read."""
    data = storage.read_bytes(path)
    if decode:
        # base_dir + origin let the multi-file containers (VRT sources,
        # the ENVI data file) find their siblings
        g = decode_image_bytes(data, base_dir=storage.dirname(path),
                               origin=storage.basename(path))
        info = g.info
    else:
        info = sniff_image_info(data)
    h, w, bands = info.height, info.width, info.count
    if dltile_from_filename:
        key = _tile_key_from_filename(path)
    elif info.geotransform is not None and info.crs is not None:
        key = "|".join((storage.basename(path), str(list(info.geotransform)),
                        info.crs))
    else:
        key = storage.basename(path)
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
                     indices, loader: Callable, store_as_array: bool,
                     progress_every: int, counter: int, files_in_worker: int
                     ) -> Tuple[int, dict]:
    """Write one shard's records; (count written, {skip reason: count}).
    ``loader(path, decode)`` gives (payload, h, w, bands, identifier)."""
    written = 0
    skipped: dict = {}
    for i in indices:
        filename = img_files[i]
        try:
            img_buf, ih, iw, ib, ikey = loader(filename, decode=store_as_array)
            lbl_buf, lh, lw, _, lkey = loader(lbl_files[i],
                                              decode=store_as_array)
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
            out_dir: str, num_shards: int, loader: Callable,
            store_as_array: bool, progress_every: int, resume: bool,
            shard_base: int = 0, total_shards: Optional[int] = None
            ) -> Tuple[int, dict]:
    """Write this worker's contiguous range of shards; (examples written,
    {skip reason: count}). ``num_shards`` is this host's shard count;
    ``shard_base`` / ``total_shards`` number them globally."""
    total_shards = total_shards or num_shards
    shards_per_worker = num_shards // len(ranges)
    lo, hi = ranges[worker_index]
    shard_ranges = np.linspace(lo, hi, shards_per_worker + 1).astype(int)
    counter = 0
    skipped: dict = {}
    for s in range(shards_per_worker):
        shard = shard_base + worker_index * shards_per_worker + s
        output_file = storage.join(out_dir,
                                   shard_filename(name, shard, total_shards))
        if resume and storage.exists(output_file):
            print(f"{datetime.now()} [worker {worker_index}]: shard "
                  f"{output_file} exists, skipping (resume)")
            continue
        writer = TFRecordWriter(output_file)
        try:
            n, shard_skips = _write_one_shard(
                writer, worker_index, img_files, lbl_files,
                range(shard_ranges[s], shard_ranges[s + 1]),
                loader, store_as_array, progress_every,
                counter, hi - lo)
        except BaseException:
            writer.abort()  # never renamed or uploaded into place
            raise
        writer.close()
        counter += n
        for k, v in shard_skips.items():
            skipped[k] = skipped.get(k, 0) + v
        print(f"{datetime.now()} [worker {worker_index}]: Wrote {n} images "
              f"to {output_file}")
        sys.stdout.flush()
    return counter, skipped


def _process_dataset(name: str, directory: str, out_directory: str,
                     num_shards: int, num_workers: int, loader: Callable,
                     store_as_array: bool, file_ext: Sequence[str],
                     progress_every: int, resume: bool, host_index: int = 0,
                     host_count: int = 1) -> int:
    if num_shards % num_workers:
        raise ValueError("Num shards must be a multiple of num workers "
                         "(incl 1*)")
    img_files, lbl_files = _find_image_files(directory, file_ext)
    total_shards, shard_base = num_shards, 0
    if host_count > 1:
        # this host's contiguous slice of the shuffled files and of the
        # shards, numbered globally
        if num_shards % host_count:
            raise ValueError("num_shards must divide evenly across hosts")
        n = len(img_files)
        lo = n * host_index // host_count
        hi = n * (host_index + 1) // host_count
        img_files, lbl_files = img_files[lo:hi], lbl_files[lo:hi]
        num_shards //= host_count
        shard_base = num_shards * host_index
        if num_shards % num_workers:
            raise ValueError("per-host shard count must be a multiple of "
                             "num workers")
    storage.makedirs(out_directory, exist_ok=True)
    spacing = np.linspace(0, len(img_files), num_workers + 1).astype(int)
    ranges = [[spacing[i], spacing[i + 1]] for i in range(num_workers)]
    print(f"Launching {num_workers} workers for spacings: {ranges}")
    sys.stdout.flush()
    args = (ranges, name, img_files, lbl_files, out_directory, num_shards,
            loader, store_as_array, progress_every, resume, shard_base,
            total_shards)
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


def process_dataset_mp(name: str, directory: str, out_directory: str,
                       num_shards: int, num_proc: Optional[int] = None,
                       dltile_from_filename: bool = True,
                       file_ext: str = "tif",
                       store_as_array: bool = True,
                       host_index: int = 0, host_count: int = 1,
                       resume: bool = False) -> int:
    """GeoTIFF chip folder (``images/`` and ``labels/``) -> ``num_shards``
    TFRecord shards in ``out_directory``, written by ``num_proc`` worker
    threads (default one a shard of this host's). ``host_index`` /
    ``host_count`` write this host's part of a run split over hosts.
    Returns the examples written."""
    return _process_dataset(
        name, directory, out_directory, num_shards,
        num_proc or num_shards // host_count,
        functools.partial(_load_any,
                          dltile_from_filename=dltile_from_filename),
        store_as_array, [file_ext], 100, resume, host_index, host_count)


def process_dataset_multithreaded(name: str, directory: str,
                                  out_directory: str, num_shards: int,
                                  num_threads: Optional[int] = None,
                                  dltile_from_filename: bool = True,
                                  convert_png_to_jpg: bool = False,
                                  store_as_array: bool = False,
                                  host_index: int = 0,
                                  host_count: int = 1,
                                  resume: bool = False) -> int:
    """PNG/JPEG chip folder (``images/`` and ``labels/``, ``.png`` and
    ``.jpg`` files) -> ``num_shards`` TFRecord shards, written by
    ``num_threads`` worker threads (default one a shard of this host's).
    ``host_index`` / ``host_count`` as for ``process_dataset_mp``.
    Returns the examples written."""
    return _process_dataset(
        name, directory, out_directory, num_shards,
        num_threads or num_shards // host_count,
        functools.partial(_load_mt, dltile_from_filename=dltile_from_filename,
                          png_to_jpg=convert_png_to_jpg),
        store_as_array, ["png", "jpg"], 1000, resume, host_index, host_count)


# the facade's names (the reference's dl_segmentation_utils/__init__.py)
images_to_tfrecords_mt = process_dataset_multithreaded
images_to_tfrecords_mp = process_dataset_mp
