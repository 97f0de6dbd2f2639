"""Training feed: sharded TFRecords -> parse -> batch -> device prefetch.

A port of the JAX package's ``pipeline/input.py``. In a
``torch.distributed`` world each rank reads its own round-robin share of
the shards (``host_shard_files``, as the JAX package deals them over its
processes).
:class:`TFRecordFeed` yields numpy (images, labels) batches with the same
shard order, interleave and shuffle buffer (``np.random.RandomState``
seeded as there), so the same shards and seed give the same batches
when parsing runs on one worker. :class:`DevicePrefetcher` keeps
``depth`` batches in flight on the card: each is pinned and copied on a
side CUDA stream by a fill thread, and the consumer's stream waits for
that copy before the batch is handed over.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import storage
from ..device import resolve_device
from ..records import parsers
from ..records.tfrecord import read_records

__all__ = ["DevicePrefetcher", "PARSE_FNS", "TFRecordFeed",
           "host_shard_files"]

PARSE_FNS = {
    "rgbraw": parsers.parse_encoded_rgb_img_proto,
    "rgbarr": parsers.parse_8bit_array_proto,
    "tifraw": parsers.parse_encoded_gdal_proto_wrapped,
    "tifraw_eager": parsers.parse_encoded_gdal_proto_eager,
    "tifarr": parsers.parse_higher_dtype_array_proto,
}


def host_shard_files(files: Sequence[str]) -> List[str]:
    """This rank's slice of the shard list, round-robin by rank over the
    sorted files (every file outside a world).

    Whole shards are dealt, so with ``repeat=False`` ranks may yield
    unequal batch counts when shard record counts differ: fine for
    training (repeating feeds); ``Trainer.evaluate`` stops every rank at
    the shortest."""
    from ..parallel.distributed import rank, world_size
    n, i = world_size(), rank()
    return [f for k, f in enumerate(sorted(files)) if k % n == i]


class TFRecordFeed:
    """Iterable over (images, labels) batches from sharded TFRecords.

    parse_mode: rgbraw | rgbarr | tifraw | tifraw_eager | tifarr.
    Labels are int32, nodata kept for the loss mask. ``scale``: None =
    uint8 / 255 and uint16 / 65535 (float32 out), a float = an explicit
    multiplier, ``"raw"`` = the parsed dtype untouched (for device pools;
    the trainer scales on the card). tifarr and tifraw parse to float32
    raw DNs, which pass every scale setting unscaled. ``verify_crc``
    checks each frame's CRCs while feeding. ``per_host`` (the default)
    reads this rank's ``host_shard_files``, as the JAX package deals
    shards over its processes. ``Trainer.place_batch`` takes the global
    batch on every rank of a world (and keeps this rank's rows), so a
    trainer's feed there reads every shard (``per_host=False``): the
    stream is in record order whatever ``num_workers``, so every rank
    reads the same batches."""

    def __init__(self, shard_pattern, parse_mode: str, batch_size: int,
                 image_size: Optional[int] = None,
                 shuffle_buffer: int = 256, seed: int = 0,
                 num_workers: int = 4, repeat: bool = True,
                 scale: Optional[float] = None,
                 drop_remainder: bool = True,
                 per_host: bool = True,
                 interleave: int = 4,
                 verify_crc: bool = False):
        if isinstance(shard_pattern, str):
            # a local glob, or a gs:// / s3:// / http(s):// prefix list
            files = storage.glob(shard_pattern)
        else:
            files = sorted(shard_pattern)
        # aborted writers leave .tmp shards; never read them
        files = [f for f in files if not f.endswith(".tmp")]
        if not files:
            raise FileNotFoundError(f"no shards match {shard_pattern!r}")
        self.files = host_shard_files(files) if per_host else list(files)
        if not self.files:
            raise RuntimeError("this host received zero shards; use more "
                               "shards than hosts")
        self.parse = PARSE_FNS[parse_mode]
        self.parse_mode = parse_mode
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.repeat = repeat
        self.scale = scale
        self.drop_remainder = drop_remainder
        self.interleave = interleave
        self.verify_crc = verify_crc
        self.records_read = 0
        self.bytes_read = 0
        self._parse_failures = 0
        self._any_parse_success = False

    def _record_stream(self) -> Iterator[bytes]:
        """Records of all shards, round-robin over ``interleave`` open
        shards, the shard order permuted anew every epoch."""
        rng = np.random.RandomState(self.seed)
        width = max(1, min(self.interleave, len(self.files)))
        while True:
            order = list(rng.permutation(len(self.files)))
            open_iters = []
            while order or open_iters:
                while order and len(open_iters) < width:
                    open_iters.append(read_records(
                        self.files[order.pop()], verify_crc=self.verify_crc))
                alive = []
                for it in open_iters:
                    rec = next(it, None)
                    if rec is None:
                        continue
                    self.bytes_read += len(rec)
                    yield rec
                    alive.append(it)
                open_iters = alive
            if not self.repeat:
                return

    def _parsed_stream(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Records parsed on ``num_workers`` threads, in record order,
        through the shuffle buffer: the same shards and seed give the
        same stream whatever the thread count and timing, so the ranks of
        a world that read the same shards hold the same batches."""
        recs = self._record_stream()
        # records taken but not yet passed on: bounds the reorder buffer
        window = self.num_workers * 8
        slots = threading.Semaphore(window)
        out_q: "queue.Queue" = queue.Queue(maxsize=window + self.num_workers)
        stop = threading.Event()
        lock = threading.Lock()
        taken = [0]

        def put(item) -> bool:
            # gives up once the consumer is gone, so no worker is left
            # blocked on a full queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                while not stop.is_set():
                    if not slots.acquire(timeout=0.5):
                        continue
                    with lock:
                        try:
                            rec = next(recs)
                        except StopIteration:
                            break
                        seq = taken[0]
                        taken[0] += 1
                    try:
                        img, lbl, _ident = self.parse(rec)
                    except Exception:  # skip corrupt records, keep feeding
                        with lock:
                            self._parse_failures += 1
                            failures = self._parse_failures
                        # every record failing = the wrong parse_mode; a
                        # repeating stream would otherwise spin forever
                        if not self._any_parse_success and failures >= 1000:
                            put(RuntimeError(
                                f"all {failures} records failed to parse "
                                f"with parse_mode={self.parse_mode!r}; "
                                "wrong storage mode for these shards?"))
                            return
                        if not put((seq, None)):
                            return
                        continue
                    self._any_parse_success = True
                    if not put((seq, (img, lbl))):
                        return
            except BaseException as e:
                # an IO error of the record stream (a truncated or
                # corrupt shard) fails the consumer
                put(e)
                return
            put(None)

        def in_order():
            """The parsed records in record order (None for a skipped
            one), each slot given back as its record passes."""
            finished, nxt, pending = 0, 0, {}
            while finished < len(threads):
                item = out_q.get()
                if item is None:
                    finished += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                pending[item[0]] = item[1]
                while nxt in pending:
                    yield pending.pop(nxt)
                    nxt += 1
                    slots.release()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        rng = np.random.RandomState(self.seed + 1)
        buf: List[Tuple[np.ndarray, np.ndarray]] = []
        try:
            for item in in_order():
                if item is None:
                    continue
                self.records_read += 1
                if self.shuffle_buffer > 1:
                    buf.append(item)
                    if len(buf) >= self.shuffle_buffer:
                        k = rng.randint(len(buf))
                        buf[k], buf[-1] = buf[-1], buf[k]
                        yield buf.pop()
                else:
                    yield item
            while buf:
                k = rng.randint(len(buf))
                buf[k], buf[-1] = buf[-1], buf[k]
                yield buf.pop()
        finally:
            stop.set()

    def _to_float_image(self, img: np.ndarray) -> np.ndarray:
        if img.ndim == 2:
            img = img[:, :, None]
        img = np.asarray(img)
        if self.scale == "raw":
            return img
        if self.scale is not None:
            return img.astype(np.float32) * self.scale
        if img.dtype == np.uint8:
            return img.astype(np.float32) / 255.0
        if img.dtype == np.uint16:
            return img.astype(np.float32) / 65535.0
        return img.astype(np.float32)

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        imgs: List[np.ndarray] = []
        lbls: List[np.ndarray] = []
        seen = 0
        yielded = 0
        for img, lbl in self._parsed_stream():
            seen += 1
            img = self._to_float_image(img)
            if lbl.ndim == 3:
                lbl = lbl[:, :, 0]
            if self.image_size is None or img.shape[:2] == (
                    self.image_size, self.image_size):
                imgs.append(img)
                lbls.append(lbl.astype(np.int32))
                if len(imgs) == self.batch_size:
                    yield np.stack(imgs), np.stack(lbls)
                    yielded += 1
                    imgs, lbls = [], []
            if yielded == 0 and not imgs and seen >= 10000:
                raise RuntimeError(
                    f"input feed produced no usable examples after {seen} "
                    f"records: check parse_mode={self.parse_mode!r} and "
                    f"image_size={self.image_size} against the shards")
        if seen == 0:
            raise RuntimeError(
                f"input feed produced no examples at all: every record "
                f"failed to parse with parse_mode={self.parse_mode!r}")
        if imgs and not self.drop_remainder:
            yield np.stack(imgs), np.stack(lbls)

    def __iter__(self):
        return self.batches()


class DevicePrefetcher:
    """Overlaps host batch assembly and the host-to-device copy with the
    card's work.

    A fill thread calls ``place(*batch)`` (e.g. ``Trainer.place_batch``:
    pinned host tensors, ``non_blocking`` copies; it returns a tuple of
    device tensors) on a side CUDA stream
    and records an event after it, keeping ``depth`` placed batches in
    a queue. ``__next__`` makes the consumer's current stream wait for
    that event and marks every tensor of the batch as used on that
    stream (``record_stream``), so that the caching allocator does not
    hand the batch's memory to the side stream's next copy while a step
    still reads it. An error of the source or of ``place`` is raised to
    the consumer. ``device=None`` is the CUDA card; with ``device="cpu"``
    the batches pass as placed."""

    def __init__(self, batches: Iterator, place: Callable, depth: int = 2,
                 device=None):
        self.src = iter(batches)
        self.place = place
        self.depth = depth
        dev = resolve_device(device)
        self._side = (torch.cuda.Stream(dev) if dev.type == "cuda"
                      else None)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exhausted = False
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        # gives up once close() is called, so the fill thread and its
        # batches never outlive an early stop of the consumer
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _placed(self, batch):
        if self._side is None:
            return self.place(*batch), None
        with torch.cuda.stream(self._side):
            placed = self.place(*batch)
            ready = torch.cuda.Event()
            ready.record(self._side)
        return placed, ready

    def _fill(self):
        try:
            for batch in self.src:
                if self._stop.is_set() or not self._put(self._placed(batch)):
                    return
            self._put(None)
        except BaseException as e:  # raised in the consumer's thread
            self._put(e)

    def close(self):
        """Stop the fill thread and drop the queued batches."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        item = self.q.get()
        if item is None:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, BaseException):
            # a caller that catches this and calls next() again gets
            # StopIteration, not a wait on a dead queue
            self._exhausted = True
            raise item
        placed, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self._side.device)
            current.wait_event(ready)
            for t in placed:
                t.record_stream(current)
        return placed
