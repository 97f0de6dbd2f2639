"""TFRecord framing: length-prefixed records with masked CRC32Cs.

A copy of the JAX package's ``records/tfrecord.py`` for local paths,
byte for byte TF's RecordWriter / RecordReader. One frame:

    uint64  length         (little-endian)
    uint32  masked_crc32c(length bytes)
    bytes   data[length]
    uint32  masked_crc32c(data)

CRCs come from the native CRC32C (``records/crc32c.py``).
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Iterator, List, Union

from .crc32c import masked_crc32c_native

__all__ = ["TFRecordWriter", "check_local", "frame_header", "list_shards",
           "read_records", "shard_filename", "writeall"]

_REMOTE = ("gs://", "s3://", "http://", "https://")
_NOT_PORTED = ("remote storage is not ported yet: ROADMAP queue 1 item 3 "
               "(storage schemes)")


def check_local(path: str) -> str:
    """``path`` unchanged if it is local; remote schemes raise."""
    if str(path).startswith(_REMOTE):
        raise NotImplementedError(f"{path}: {_NOT_PORTED}")
    return path


def writeall(fileobj, data) -> int:
    """Write all of ``data``, looping on short writes (a raw file may
    write fewer bytes than asked; a torn frame must never be renamed
    into place as a complete shard)."""
    view = memoryview(data)
    total = len(view)
    written = 0
    while written < total:
        n = fileobj.write(view[written:])
        if n is None:  # buffered writers return None only on success
            return total
        if n <= 0:
            raise IOError("write() made no progress")
        written += n
    return total


def frame_header(length: int) -> bytes:
    """The 12 bytes before a record of ``length`` bytes."""
    header = struct.pack("<Q", length)
    return header + struct.pack("<I", masked_crc32c_native(header))


class TFRecordWriter:
    """Streaming TFRecord writer. Data goes to ``<path>.tmp``, renamed
    into place on close(), so an existing shard is always a complete one
    (what makes the writers' ``resume`` sound)."""

    def __init__(self, path: str, buffering: int = -1):
        self._path = check_local(path)
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb", buffering=buffering)

    @property
    def fileobj(self):
        """The underlying binary file, for pre-framed writes
        (``records.example.write_example_framed``)."""
        return self._f

    def write(self, record: Union[bytes, memoryview]) -> None:
        record = bytes(record)
        writeall(self._f, frame_header(len(record)))
        writeall(self._f, record)
        writeall(self._f, struct.pack("<I", masked_crc32c_native(record)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
            os.replace(self._tmp, self._path)

    def abort(self) -> None:
        """Close without renaming into place: the shard stays a ``.tmp``,
        which readers and ``resume`` ignore."""
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            self.abort()
        else:
            self.close()


def read_records(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Raw record payloads of one local TFRecord file."""
    with open(check_local(path), "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise IOError(f"truncated record header in {path}")
            (length,) = struct.unpack("<Q", header)
            hcrc_raw = f.read(4)
            if len(hcrc_raw) < 4:
                raise IOError(f"truncated record header in {path}")
            (hcrc,) = struct.unpack("<I", hcrc_raw)
            if verify_crc and masked_crc32c_native(header) != hcrc:
                raise IOError(f"corrupt record header CRC in {path}")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"truncated record in {path}")
            dcrc_raw = f.read(4)
            if len(dcrc_raw) < 4:
                raise IOError(f"truncated record in {path}")
            (dcrc,) = struct.unpack("<I", dcrc_raw)
            if verify_crc and masked_crc32c_native(data) != dcrc:
                raise IOError(f"corrupt record data CRC in {path}")
            yield data


def shard_filename(name: str, shard: int, num_shards: int) -> str:
    """'%s-%.5d-of-%.5d', the shard naming contract."""
    return "%s-%.5d-of-%.5d" % (name, shard, num_shards)


def list_shards(directory: str, name: str) -> List[str]:
    """The final shards of a named dataset in a local directory (never
    the ``.tmp`` files of aborted writers)."""
    return sorted(glob.glob(os.path.join(check_local(directory),
                                         f"{name}-?????-of-?????")))
