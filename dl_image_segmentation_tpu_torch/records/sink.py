"""Records sinks: push finished TFRecord shards to a destination.

A copy of the JAX package's ``records/sink.py``. The reference
sketches uploading shards to Descartes Labs Storage through signed URLs
(``parse_tfrecords.ipynb`` cells 39-46). There is no such service here,
so this is a sink interface with two backends:

* ``LocalDirSink`` -- copy (hardlink when possible) into a managed
  root and record a manifest; the "blob store on a shared filesystem"
  deployment. The root may also be gs:// or s3://, where the JAX
  package's sink writes a local ``gs:`` tree instead.
* ``SignedURLSink`` -- HTTP PUT each shard to a caller-supplied
  presigned URL (the exact S3/GCS/DL-Storage upload shape), stdlib
  urllib only.

``push_shards`` drives either from a glob (local, gs://, s3:// or
http(s)://), shard-level resumable through the manifest. A remote shard
is streamed through a local spool file for the signed-URL PUT, where the
JAX package's sink reads it with ``os.path.getsize`` and fails.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Dict, List

from .. import storage


class RecordsSink:
    """Destination for finished shards. Implementations must be safe
    to call from multiple threads (one shard per call)."""

    def put_shard(self, path: str) -> str:
        """Upload/store one shard file; returns its remote identifier."""
        raise NotImplementedError

    def exists(self, shard_name: str) -> bool:
        """True when the shard is already at the destination (resume)."""
        return False


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with storage.open_read(path) as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class LocalDirSink(RecordsSink):
    """Copy shards into a managed directory with a JSON manifest
    (name -> {sha256, bytes}). The directory may be local, gs:// or
    s3://. Into a local directory a local shard is hardlinked when
    source and destination share a filesystem, else copied; into a
    remote one every shard is uploaded."""

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        storage.makedirs(root)
        self._manifest_path = storage.join(root, "manifest.json")
        if storage.exists(self._manifest_path):
            self.manifest: Dict[str, dict] = json.loads(
                storage.read_bytes(self._manifest_path))
        else:
            self.manifest = {}

    def exists(self, shard_name: str) -> bool:
        return (shard_name in self.manifest
                and storage.exists(storage.join(self.root, shard_name)))

    def put_shard(self, path: str) -> str:
        name = storage.basename(path)
        dest = storage.join(self.root, name)
        if storage.is_remote(dest):
            entry = self._upload(path, dest)
        else:
            tmp = dest + ".tmp"
            if storage.is_remote(path):
                # remote shard -> local sink: stream, don't slurp
                storage.download_file(path, tmp)
            else:
                try:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    os.link(path, tmp)
                except OSError:
                    shutil.copyfile(path, tmp)
            os.replace(tmp, dest)
            entry = {"sha256": _sha256(dest),
                     "bytes": os.path.getsize(dest)}
        self._record(name, entry)
        return dest

    @staticmethod
    def _upload(path: str, dest: str) -> dict:
        """Upload one shard to a remote root; a remote shard passes
        through a local spool file. Returns its manifest entry, taken
        from the bytes that were uploaded."""
        with tempfile.TemporaryDirectory() as d:
            local = path
            if storage.is_remote(path):
                local = os.path.join(d, storage.basename(path))
                storage.download_file(path, local)
            entry = {"sha256": _sha256(local),
                     "bytes": os.path.getsize(local)}
            storage.upload_file(local, dest)
        return entry

    @contextlib.contextmanager
    def _root_lock(self):
        """An exclusive flock on a local root, held across sinks and
        processes. An object store has no lock: two processes pushing
        to one remote root at once may drop each other's manifest
        entries, and a dropped entry only makes resume push that shard
        again."""
        if storage.is_remote(self.root):
            yield
            return
        with open(self._manifest_path + ".lock", "a") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            yield

    def _record(self, name: str, entry: dict) -> None:
        """The read-merge-write of the manifest runs under this sink's
        lock (threads) and the root's lock, so no writer on a local
        root drops another's entry; the JAX package merges under the
        thread lock alone. The rewrite is atomic in every backend: a crash mid-dump
        must not truncate the manifest that shard-level resume depends
        on."""
        with self._lock, self._root_lock():
            self.manifest[name] = entry
            if storage.exists(self._manifest_path):
                try:
                    on_disk = json.loads(
                        storage.read_bytes(self._manifest_path))
                    # keep entries another sink added since init
                    on_disk.update(self.manifest)
                    self.manifest = on_disk
                except (ValueError, OSError):
                    pass  # our in-memory copy is the best we have
            storage.write_bytes(self._manifest_path, json.dumps(
                self.manifest, indent=1, sort_keys=True).encode("utf-8"))


class SignedURLSink(RecordsSink):
    """HTTP PUT each shard to a presigned URL. ``urls`` maps shard
    basename -> URL (the shape a storage service's
    create-signed-upload-url API returns, parse nb cell 43)."""

    def __init__(self, urls: Dict[str, str], timeout: float = 60.0):
        self.urls = dict(urls)
        self.timeout = timeout
        self.uploaded: List[str] = []

    def put_shard(self, path: str) -> str:
        name = storage.basename(path)
        url = self.urls.get(name)
        if url is None:
            raise KeyError(f"no signed URL provided for shard {name!r}")
        if not storage.is_remote(path):
            self._put(name, path, url)
        else:
            with tempfile.TemporaryDirectory() as d:
                local = os.path.join(d, name)
                storage.download_file(path, local)
                self._put(name, local, url)
        self.uploaded.append(name)
        return url

    def _put(self, name: str, path: str, url: str) -> None:
        import urllib.request
        # stream the file object (urllib sends file-likes chunked off
        # disk when Content-Length is set) -- shards run to GBs and
        # must not be materialized in memory for the PUT
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            req = urllib.request.Request(
                url, data=f, method="PUT",
                headers={"Content-Type": "application/octet-stream",
                         "Content-Length": str(size)})
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                if resp.status not in (200, 201, 204):
                    raise IOError(
                        f"upload of {name} failed: HTTP {resp.status}")


def push_shards(pattern, sink: RecordsSink,
                resume: bool = True) -> List[str]:
    """Push every shard matching ``pattern`` (glob or list of paths)
    through ``sink``. Skips shards the sink already has when
    ``resume``. Returns the remote identifiers of pushed shards."""
    if isinstance(pattern, str):
        files = storage.glob(pattern)
    else:
        files = sorted(pattern)
    # aborted writers deliberately leave .tmp files; never push them
    files = [f for f in files if not f.endswith(".tmp")]
    if not files:
        raise FileNotFoundError(f"no shards match {pattern!r}")
    out = []
    skipped = 0
    for f in files:
        if resume and sink.exists(storage.basename(f)):
            skipped += 1
            continue
        out.append(sink.put_shard(f))
    print(f"pushed {len(out)} shard(s), {skipped} already present")
    return out


def sink_from_dest(dest: str) -> RecordsSink:
    """CLI helper: a directory (local, gs:// or s3://) -> LocalDirSink;
    a JSON file (local or remote) of {shard_name: url} ->
    SignedURLSink."""
    if dest.endswith(".json") and (storage.exists(dest)
                                   if storage.is_remote(dest)
                                   else os.path.isfile(dest)):
        return SignedURLSink(json.loads(storage.read_bytes(dest)))
    return LocalDirSink(dest)
