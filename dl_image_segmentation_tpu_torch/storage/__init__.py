"""Pluggable filesystem layer: local paths, ``gs://``, ``s3://`` and
read-only ``http(s)://``.

A copy of the JAX package's ``storage/__init__.py``. The reference reads
and writes everything through ``tf.io.gfile``
(``_img_to_tf_threaded.py:87-88``, ``_img_to_tf_mp.py:43-44``), whose
filesystem registry dispatches on the scheme. This module is that
dispatch point for the port: chip folders, TFRecord shards, shard
globs, ``--geotiff`` rasters, checkpoints and catalog roots all go
through these functions, so any CLI path argument may be
``gs://bucket/...`` or ``s3://bucket/...`` (and, for reads,
``https://host/...``).

Semantics that the data plane depends on:

* ``write_bytes`` is ATOMIC in every backend: local writes go
  tmp + os.replace; GCS and S3 object creation is atomic (the object
  is invisible until the upload completes). This keeps the 'existing
  shard/chip == complete shard/chip' resume invariant.
* ``glob``/``listdir`` on remote URIs list by prefix, then filter, so
  shard patterns like ``gs://b/recs/name-*`` work exactly like local
  globs (``*`` never crosses ``/``).
* ``makedirs`` is a no-op on object stores (there are no directories).

Backends are clients with one shared method surface
(download/upload/stat/delete/list/rewrite): ``gcs.py`` (JSON API),
``s3.py`` (REST + SigV4) and ``httpread.py`` (read-only);
``client_for`` picks by scheme.

Local paths take a short-circuit at the top of every function: one
``startswith`` per call and nothing else.
"""

from __future__ import annotations

import io
import os
import tempfile
from typing import IO, List, Optional

from .gcs import GCSClient, get_client, split_gcs_path  # noqa: F401

__all__ = [
    "is_remote", "read_bytes", "write_bytes", "exists", "listdir",
    "glob", "makedirs", "unlink", "open_read", "replace", "join",
    "basename", "dirname", "SpooledWriter", "download_dir", "upload_dir",
    "split_url", "client_for", "upload_file", "download_file", "size",
]

_SCHEMES = ("gs://", "s3://", "https://", "http://")


def is_remote(path) -> bool:
    return isinstance(path, str) and path.startswith(_SCHEMES)


def split_url(path: str):
    """'gs://b/k' or 's3://b/k' (or 'https://host/k') -> (scheme,
    bucket, key); scheme keeps its '://' so rebuilt URLs are
    f'{scheme}{bucket}/{key}'. For http(s), 'bucket' is the
    authority (host[:port])."""
    for scheme in _SCHEMES:
        if path.startswith(scheme):
            rest = path[len(scheme):]
            bucket, _, name = rest.partition("/")
            if not bucket:
                raise ValueError(f"remote path has no bucket: {path!r}")
            return scheme, bucket, name
    raise ValueError(f"not a remote path: {path!r}")


def client_for(path: str):
    """(client, bucket, key) for a remote path — the client exposes
    the shared method surface (download/upload/stat/delete/list/
    rewrite) regardless of backend (storage.gcs / storage.s3 /
    storage.httpread, the last read-only: its writes raise
    PermissionError)."""
    scheme, bucket, name = split_url(path)
    if scheme == "s3://":
        from .s3 import get_s3_client
        return get_s3_client(), bucket, name
    if scheme in ("https://", "http://"):
        from .httpread import get_http_client
        return get_http_client(scheme), bucket, name
    return get_client(), bucket, name


def join(base: str, *parts: str) -> str:
    """os.path.join that never mangles gs:// (and never lets a later
    absolute component swallow a remote base)."""
    if not is_remote(base):
        return os.path.join(base, *parts)
    out = base.rstrip("/")
    for p in parts:
        out += "/" + p.strip("/")
    return out


def basename(path: str) -> str:
    return path.rstrip("/").rsplit("/", 1)[-1] if is_remote(path) \
        else os.path.basename(path)


def dirname(path: str) -> str:
    if not is_remote(path):
        return os.path.dirname(path)
    root = path.rstrip("/")
    head = root.rsplit("/", 1)[0]
    return root if head.endswith(":/") else head  # bucket root: no parent


def read_bytes(path: str) -> bytes:
    if not is_remote(path):
        with open(path, "rb") as f:
            return f.read()
    cli, bucket, name = client_for(path)
    return cli.download(bucket, name)


def read_range(path: str, start: int, end: Optional[int] = None) -> bytes:
    """[start, end] inclusive byte range (ranged GET on gs://)."""
    if not is_remote(path):
        with open(path, "rb") as f:
            f.seek(start)
            return f.read() if end is None else f.read(end - start + 1)
    cli, bucket, name = client_for(path)
    return cli.download(bucket, name, start=start, end=end)


def open_read(path: str) -> IO[bytes]:
    """Binary read handle. gs:// objects are fetched whole into memory
    (shards are tens of MB; the feed's interleave keeps only a few
    open) — for partial access use read_range."""
    if not is_remote(path):
        return open(path, "rb")
    return io.BytesIO(read_bytes(path))


def write_bytes(path: str, data: bytes) -> None:
    """Atomic whole-file write (see module docstring)."""
    if not is_remote(path):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return
    cli, bucket, name = client_for(path)
    cli.upload(bucket, name, data)


def upload_file(local_path: str, dst: str) -> None:
    """Stream a file to ``dst`` with bounded memory. Remote targets use
    the backend's streaming protocol (GCS resumable upload / S3
    multipart past one part), so objects beyond S3's 5 GiB single-PUT
    cap — e.g. stitched BigTIFF mosaics — upload fine; local targets
    copy atomically (tmp + rename). The streaming peer of
    ``write_bytes``; object visibility stays atomic in every backend.
    """
    if not is_remote(dst):
        import shutil
        d = os.path.dirname(dst)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = dst + ".tmp"
        shutil.copyfile(local_path, tmp)
        os.replace(tmp, dst)
        return
    cli, bucket, name = client_for(dst)
    size = os.path.getsize(local_path)
    with open(local_path, "rb") as f:
        cli.upload_stream(bucket, name, f, size=size)


def download_file(src: str, local_path: str) -> None:
    """Stream ``src`` into a local file with bounded memory (ranged
    GETs for remote sources), atomically (tmp + rename)."""
    d = os.path.dirname(local_path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = local_path + ".tmp"
    if not is_remote(src):
        import shutil
        shutil.copyfile(src, tmp)
        os.replace(tmp, local_path)
        return
    cli, bucket, name = client_for(src)
    try:
        with open(tmp, "wb") as f:
            cli.download_stream(bucket, name, f)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, local_path)


def exists(path: str) -> bool:
    if not is_remote(path):
        return os.path.exists(path)
    cli, bucket, name = client_for(path)
    return cli.stat(bucket, name) is not None


def size(path: str) -> int:
    """The file's or object's size in bytes; FileNotFoundError when it
    does not exist."""
    if not is_remote(path):
        return os.path.getsize(path)
    cli, bucket, name = client_for(path)
    meta = cli.stat(bucket, name)
    if meta is None:
        raise FileNotFoundError(path)
    return int(meta["size"])


def listdir(path: str) -> List[str]:
    """Names (not full paths) of direct children. On gs:// a 'child'
    is an object one level below the prefix, or a pseudo-folder name
    (trailing '/' stripped)."""
    if not is_remote(path):
        return sorted(os.listdir(path))
    cli, bucket, prefix = client_for(path)
    if prefix and not prefix.endswith("/"):
        prefix += "/"
    items, prefixes = cli.list(bucket, prefix, delimiter="/")
    names = [it["name"][len(prefix):] for it in items]
    names += [p[len(prefix):].rstrip("/") for p in prefixes]
    return sorted(n for n in names if n)


def glob(pattern: str) -> List[str]:
    """Shell-style glob. gs:// patterns list the static prefix then
    match, so 'gs://b/recs/name-*' behaves like the local glob that
    shard patterns assume, including that '*' and '?' never cross '/'
    (a shard pattern must not pull nested objects)."""
    if not is_remote(pattern):
        import glob as _glob
        return sorted(_glob.glob(pattern))
    if not any(ch in pattern for ch in "*?["):
        # no wildcards: a single existence probe instead of a prefix
        # list -- and the only option on https:// servers without
        # directory indexes
        return [pattern] if exists(pattern) else []
    scheme, bucket, name_pat = split_url(pattern)
    cli = client_for(pattern)[0]
    cut = len(name_pat)
    for ch in "*?[":
        k = name_pat.find(ch)
        if k != -1:
            cut = min(cut, k)
    static = name_pat[:cut]
    rx = _glob_regex(name_pat)
    items, _ = cli.list(bucket, static)
    return sorted(f"{scheme}{bucket}/{it['name']}" for it in items
                  if rx.fullmatch(it["name"]))


def _glob_regex(pat: str):
    """Glob pattern -> regex with local-glob semantics: '*' and '?'
    never match '/', '[...]' classes pass through ('[!' negates)."""
    import re
    out = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if c == "*":
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        elif c == "[":
            j = i + 1
            if j < len(pat) and pat[j] in "!]":
                j += 1
            while j < len(pat) and pat[j] != "]":
                j += 1
            if j >= len(pat):
                out.append(re.escape(c))  # unclosed: literal '['
            else:
                inner = pat[i + 1:j]
                if inner.startswith("!"):
                    inner = "^" + inner[1:]
                out.append("[" + inner + "]")
                i = j
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out) + r"\Z")


def makedirs(path: str, exist_ok: bool = True) -> None:
    if not is_remote(path):
        os.makedirs(path, exist_ok=exist_ok)


def unlink(path: str) -> None:
    if not is_remote(path):
        os.unlink(path)
        return
    cli, bucket, name = client_for(path)
    if not cli.delete(bucket, name):
        raise FileNotFoundError(path)


def replace(src: str, dst: str) -> None:
    """Atomic-rename semantics. Local: os.replace. gs://: server-side
    rewrite + delete (the WRITE into dst is still atomic; the pair is
    not, which no caller depends on — shard writers upload the final
    name directly instead)."""
    if not is_remote(src) and not is_remote(dst):
        os.replace(src, dst)
        return
    if is_remote(src) and is_remote(dst):
        s_scheme, sb, sn = split_url(src)
        d_scheme, db, dn = split_url(dst)
        cli = client_for(src)[0]
        if s_scheme == d_scheme:
            cli.rewrite(sb, sn, db, dn)
        else:  # cross-backend: move the bytes through this host
            client_for(dst)[0].upload(db, dn, cli.download(sb, sn))
        cli.delete(sb, sn)
        return
    if is_remote(dst):
        upload_file(src, dst)
        os.unlink(src)
        return
    download_file(src, dst)
    unlink(src)


class SpooledWriter:
    """File-like writer for any path: local writes spool to
    ``<path>.tmp`` and rename on close; gs:// writes spool to a local
    temp file and upload on close (one atomic object creation). Both
    give 'final path exists == write completed'. Exposes a REAL file
    (``fileobj``/``fileno``) so native code can write to the fd."""

    def __init__(self, path: str, buffering: int = -1):
        self.path = path
        self._remote = is_remote(path)
        if self._remote:
            fd, self._spool = tempfile.mkstemp(suffix=".gcs-spool")
            os.close(fd)
        else:
            self._spool = path + ".tmp"
        self._f = open(self._spool, "wb", buffering=buffering)
        self._done = False

    @property
    def fileobj(self) -> IO[bytes]:
        return self._f

    def write(self, data) -> int:
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._done:
            return
        self._done = True
        self._f.close()
        if self._remote:
            try:
                # streaming upload (GCS resumable / S3 multipart):
                # spool size never constrains memory
                upload_file(self._spool, self.path)
            finally:
                os.unlink(self._spool)
        else:
            os.replace(self._spool, self.path)

    def abort(self) -> None:
        """Discard without publishing (local keeps the .tmp for
        debugging, matching TFRecordWriter.abort; the remote spool is
        deleted — nothing was ever uploaded)."""
        if self._done:
            return
        self._done = True
        self._f.close()
        if self._remote:
            os.unlink(self._spool)


def upload_dir(local_dir: str, remote_dir: str) -> int:
    """Mirror a local directory tree to gs://or s3:// (used by remote
    checkpointing), streaming each file with bounded memory. Returns
    files uploaded."""
    n = 0
    for root, _dirs, files in os.walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        for fn in files:
            dst = join(remote_dir, fn) if rel == "." \
                else join(remote_dir, rel.replace(os.sep, "/"), fn)
            upload_file(os.path.join(root, fn), dst)
            n += 1
    return n


def download_dir(remote_dir: str, local_dir: str,
                 delete_extras: bool = False) -> int:
    """Mirror a remote prefix into a local directory tree.

    With ``delete_extras`` the local tree becomes an EXACT mirror:
    local files absent remotely are deleted (and emptied directories
    pruned). Checkpoint staging uses this so a stale staging dir from
    an earlier run at the same URI cannot fabricate a resume point —
    the remote is the source of truth."""
    cli, bucket, prefix = client_for(remote_dir)
    if prefix and not prefix.endswith("/"):
        prefix += "/"
    items, _ = cli.list(bucket, prefix)
    n = 0
    keep = set()
    for it in items:
        rel = it["name"][len(prefix):]
        if not rel or rel.endswith("/"):
            continue  # pseudo-folder placeholder (console-created)
        keep.add(rel)
        dst = os.path.join(local_dir, *rel.split("/"))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            cli.download_stream(bucket, it["name"], f)
        n += 1
    if delete_extras and os.path.isdir(local_dir):
        for root, dirs, files in os.walk(local_dir, topdown=False):
            rel_root = os.path.relpath(root, local_dir)
            for fn in files:
                rel = fn if rel_root == "." else \
                    f"{rel_root.replace(os.sep, '/')}/{fn}"
                if rel not in keep:
                    os.unlink(os.path.join(root, fn))
            for d in dirs:
                try:
                    os.rmdir(os.path.join(root, d))
                except OSError:
                    pass
    return n
